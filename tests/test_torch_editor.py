"""The port's voicing editor (goofer_tpu_torch.editor) against goofer_tpu's,
on the CPU: the headless core, the tkinter front-end driven through
tests/fake_tk.py (after tests/test_gui_editor.py), the `.goofy` batch
mode and the CLI's editor mode, SE1 through the CLI and the server's
handler with a scripted hook, and the preview synthesis."""
import pytest

torch = pytest.importorskip("torch")

import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import urllib.request  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
from scipy.io import wavfile  # noqa: E402

import goofer_tpu.editor.core as j_core  # noqa: E402
import goofer_tpu.editor.gui as j_gui  # noqa: E402
from goofer_tpu_torch import cli  # noqa: E402
from goofer_tpu_torch.editor import core, gui  # noqa: E402
from goofer_tpu_torch.io.goofy import (  # noqa: E402
    load_features,
    save_features,
)
from goofer_tpu_torch.ops.envelope import decode_env_from_knots  # noqa: E402
from goofer_tpu_torch.sampler import resampler, server  # noqa: E402
from goofer_tpu_torch.sampler.resampler import GooferResampler  # noqa: E402
from goofer_tpu_torch.utils.audio_io import write_wav  # noqa: E402
from goofer_tpu_torch.utils.metrics import lsd_db  # noqa: E402
from tests import fake_tk  # noqa: E402

SR = 44100
VOICE = Path(__file__).parent / "golden" / "voice"
NOTE = ["C4", "100", "", "0", "300", "60", "0", "100", "0", "!120", "AA"]


@pytest.fixture
def tkpatch(monkeypatch):
    fake_tk.reset()
    monkeypatch.setitem(sys.modules, "tkinter", fake_tk)
    monkeypatch.setitem(sys.modules, "tkinter.ttk", fake_tk.ttk)
    return fake_tk


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("GOOFER_TPU_TORCH_DEVICE", "cpu")


def _knot_pack(rng, k=48, t=20):
    return {"mode": "knots",
            "knot_vals_log": rng.standard_normal((k, t)).astype(np.float16),
            "hz_knots": np.linspace(0, 22050, k).astype(np.float32),
            "n_bins": 513, "n_fft": 1024, "sr": 44100}


def _same_features(a, b):
    """Two load_features tuples hold equal arrays."""
    env_a, env_b = a[0], b[0]
    if isinstance(env_a, dict):
        for k in ("knot_vals_log", "hz_knots"):
            np.testing.assert_array_equal(env_a[k], env_b[k])
        assert [env_a[k] for k in ("n_bins", "n_fft", "sr")] == [
            env_b[k] for k in ("n_bins", "n_fft", "sr")]
    else:
        np.testing.assert_array_equal(env_a, env_b)
    for x, y in zip(a[1:3], b[1:3]):
        np.testing.assert_array_equal(x, y)
    assert sorted(a[3]) == sorted(b[3])
    for k in a[3]:
        np.testing.assert_array_equal(a[3][k], b[3][k])
    assert a[4:] == b[4:]


# ------------------------------------------------------------------- core

@pytest.mark.parametrize("reversed_", [False, True])
def test_write_back_voicing_equal_goofer_tpu(tmp_path, reversed_):
    """The edited span lands at [50, 150), or flipped to [n-150, n-50) for
    a reversed snippet, and both packages write the same contents."""
    n = 400
    rng = np.random.default_rng(4)
    pack = _knot_pack(rng)
    f0 = rng.uniform(100, 300, n).astype(np.float32)
    forms = {1: np.full(20, 700.0)}
    edited = np.zeros(100, dtype=np.float32)
    edited[:10] = 1.0
    paths = []
    for name, mod in (("ours", core), ("theirs", j_core)):
        p = tmp_path / f"{name}_features.goofy"
        save_features(p, pack, f0, np.ones(n, np.float32), forms, SR, n)
        mod.write_back_voicing(str(p), edited, 50, 150, reversed_)
        paths.append(p)
    ours, theirs = (load_features(p) for p in paths)
    _same_features(ours, theirs)
    m = ours[2]
    lo, hi = (n - 150, n - 50) if reversed_ else (50, 150)
    want = edited[::-1] if reversed_ else edited
    np.testing.assert_array_equal(m[lo:hi], want)
    assert np.all(m[:lo] == 1) and np.all(m[hi:] == 1)
    assert not list(tmp_path.glob("*.tmp"))


@pytest.mark.parametrize("case", ["paint", "brush", "fill_interp",
                                  "fill_global", "fill_default"])
def test_core_equal_goofer_tpu(case):
    calls = {
        "paint": lambda m: m.paint_mask_span(np.zeros(10), 2, 6, True),
        "brush": lambda m: m.apply_f0_brush(
            np.full(10, 200.0), np.r_[np.zeros(2), np.ones(4), np.zeros(4)],
            999.0),
        "fill_interp": lambda m: m.fill_f0_for_painted_voicing(
            np.array([0, 0, 100, 0, 0, 200, 0], np.float32), np.ones(7)),
        "fill_global": lambda m: m.fill_f0_for_painted_voicing(
            np.zeros(5, np.float32), np.ones(5),
            f0_global=np.array([0, 0, 321.0, 0]), seg_mid=1),
        "fill_default": lambda m: m.fill_f0_for_painted_voicing(
            np.zeros(5, np.float32), np.ones(5)),
    }
    ours, theirs = calls[case](core), calls[case](j_core)
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    want = {"paint": [0, 0, 1, 1, 1, 1, 0, 0, 0, 0],
            "brush": [0, 0, 500, 500, 500, 500, 0, 0, 0, 0],
            "fill_global": [321.0] * 5, "fill_default": [120.0] * 5}
    if case in want:
        assert ours.tolist() == want[case]


# -------------------------------------------------------------- front-end

def _mk_ui(n=8000, init_mask=None, features=None, module=gui, **kw):
    root = fake_tk.Tk()
    y = np.sin(np.linspace(0, 80 * np.pi, n)).astype(np.float32) * 0.4
    ui = module.VoicingEditorUI(root, y, SR, init_mask=init_mask,
                                features=features, **kw)
    return root, ui


def _paint(ui, x0, x1, button=3):
    ui.canvas.fire(f"<Button-{button}>", x=x0)
    ui.canvas.fire(f"<B{button}-Motion>", x=x1)
    ui.canvas.fire(f"<ButtonRelease-{button}>")


def _span(x0, x1, w=800, n=8000):
    return int(x0 / w * n), int(x1 / w * n) + 1


def test_canvas_paint_lmb_rmb_and_mode_keys(tkpatch):
    """LMB paints voiced, RMB unvoiced; keys 2/3 pin the polarity."""
    _, ui = _mk_ui()
    _paint(ui, 200, 400, button=3)
    a, b = _span(200, 400)
    assert (ui.mask[a:b] == 0).all()
    assert (ui.mask[:a] == 1).all() and (ui.mask[b:] == 1).all()
    _paint(ui, 250, 300, button=1)
    a2, b2 = _span(250, 300)
    assert (ui.mask[a2:b2] == 1).all()
    ui.win.bindings["2"](fake_tk.Event())
    assert ui.edit_mode == "voiced"
    _paint(ui, 200, 400, button=3)
    assert (ui.mask[a:b] == 1).all()
    ui.win.bindings["3"](fake_tk.Event())
    _paint(ui, 600, 700, button=1)
    c, d = _span(600, 700)
    assert (ui.mask[c:d] == 0).all()
    ui.win.bindings["1"](fake_tk.Event())
    _paint(ui, 100, 50, button=3)               # leftwards drag
    e, f = _span(50, 100)
    assert (ui.mask[e:f] == 0).all()


def test_mode_combobox_and_middle_button(tkpatch):
    _, ui = _mk_ui()
    _paint(ui, 200, 400, button=2)              # MMB in "both": unvoiced
    a, b = _span(200, 400)
    assert (ui.mask[a:b] == 0).all()
    ui.mode_combo.select("voiced")
    assert ui.edit_mode == "voiced"
    _paint(ui, 200, 400, button=2)
    assert (ui.mask[a:b] == 1).all()
    ui.mode_combo.select("unvoiced")
    _paint(ui, 600, 700, button=1)
    c, d = _span(600, 700)
    assert (ui.mask[c:d] == 0).all()
    ui.win.bindings["1"](fake_tk.Event())
    assert ui.edit_mode == "both" and ui.mode_var.get() == "both"
    assert ui.mode_combo.kw.get("takefocus") is False
    ui.mode_combo.fire("<FocusIn>", widget=ui.mode_combo)


def test_zoom_scroll_view_and_redraw(tkpatch):
    _, ui = _mk_ui()
    ui.zoom_slider.kw["command"]("4")
    assert ui._view_span() == (0, 2000)
    ui.scrollbar.kw["command"]("moveto", "0.5")
    assert ui._view_span() == (3000, 5000)
    lo, hi = ui.scrollbar.set_calls[-1]
    assert lo == pytest.approx(0.5) and hi == pytest.approx(0.75)
    ui.scrollbar.kw["command"]("scroll", "1")
    assert ui._view_span()[0] > 3000
    _paint(ui, 0, 799, button=3)
    assert {"rectangle", "line", "text"} <= {it[0] for it in ui.canvas.items}
    hud = ui.canvas.items_of("text")[0][2]["text"]
    assert "mode=" in hud and "zoom=" in hud
    assert "#2a2a2a" in {it[2]["fill"]
                         for it in ui.canvas.items_of("rectangle")}


def test_f0_brush_slider_and_paint_coupling(tkpatch):
    _, ui = _mk_ui()
    ui.init_f0_track(np.full(8000, 200.0, np.float32))
    assert (ui.f0 == 120.0).all()
    ui.f0_var.set(300.0)
    ui.f0_slider.fire("<ButtonRelease-1>")
    assert (ui.f0 == 300.0).all()
    _paint(ui, 200, 400, button=3)
    a, b = _span(200, 400)
    assert (ui.f0[a:b] == 0).all() and (ui.mask[a:b] == 0).all()
    ui.f0_var.set(250.0)
    _paint(ui, 250, 300, button=1)
    a2, b2 = _span(250, 300)
    assert (ui.f0[a2:b2] == 250.0).all()
    ui.f0_slider.fire("<ButtonRelease-1>")
    assert (ui.f0[a2:b2] == 250.0).all() and (ui.f0[b:a2] == 250.0).all()


@pytest.mark.parametrize("how", ["Apply", "Cancel", "WM_DELETE_WINDOW"])
def test_lifecycle_apply_cancel_wm_delete(tkpatch, how):
    _, ui = _mk_ui()
    if how == "WM_DELETE_WINDOW":
        ui.win.protocols[how]()
    else:
        fake_tk.find_button(ui.win, how).invoke()
    assert ui.ok == (how == "Apply") and ui.win.destroyed


def test_interactive_voicing_modal_contract(tkpatch):
    """The edited mask on Apply, None on Cancel
    (ref: SillyEditor.py:492-502)."""
    y = np.zeros(4000, np.float32)

    def apply_scenario(win):
        canvas = fake_tk.find_all(win, fake_tk.Canvas)[0]
        canvas.fire("<Button-3>", x=0)
        canvas.fire("<B3-Motion>", x=399)
        canvas.fire("<ButtonRelease-3>")
        fake_tk.find_button(win, "Apply").invoke()

    fake_tk.push_scenario(apply_scenario)
    out = gui.interactive_voicing(y, SR)
    assert out is not None and out.dtype == np.float32
    b = int(399 / 800 * 4000) + 1
    assert (out[:b] == 0).all() and (out[b:] == 1).all()
    fake_tk.push_scenario(
        lambda win: fake_tk.find_button(win, "Cancel").invoke())
    assert gui.interactive_voicing(y, SR) is None


def test_available_interactive_hook(monkeypatch, tkpatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    assert gui.available_interactive_hook() is None
    monkeypatch.setenv("DISPLAY", ":0")
    assert gui.available_interactive_hook() is gui.interactive_voicing


def _play(module, monkeypatch, hop=None, tframes=32):
    """Press Play on a zoomed UI of ``module`` with features; returns the
    preview's arguments, the played audio and the visible span."""
    n = 8000
    rng = np.random.default_rng(9)
    env = rng.random((64, tframes)).astype(np.float32)
    f0i = rng.uniform(100, 300, n).astype(np.float32)
    f0i[1000:1500] = 0.0
    forms = {1: rng.uniform(500, 900, tframes).astype(np.float32)}
    calls, played = [], []

    def fake_preview(env_seg, f0_seg, mask_seg, forms_seg, sr0, *args,
                     **kw):
        calls.append((env_seg, f0_seg, mask_seg, forms_seg, sr0, args, kw))
        return np.full(len(f0_seg), 0.25, np.float32)

    monkeypatch.setattr(module, "_preview_synthesis", fake_preview)
    sd = type(sys)("sounddevice")
    sd.play = lambda y, sr: played.append((np.asarray(y), sr))
    sd.stop = lambda: None
    monkeypatch.setitem(sys.modules, "sounddevice", sd)
    kw = {} if hop is None else {"hop": hop, "device": "cpu"}
    _, ui = _mk_ui(n=n, features=(env, f0i, np.ones(n), forms, SR, n),
                   module=module, **kw)
    ui.init_f0_track(f0i)
    _paint(ui, 100, 160, button=1)              # voiced where f0 was 0
    ui.zoom_slider.kw["command"]("2")
    fake_tk.find_button(ui.win, "Play").invoke()
    return calls, played, ui._view_span()


def test_play_previews_visible_span_as_goofer_tpu(tkpatch, monkeypatch):
    """Play previews the VISIBLE span: at the default hop, the same env,
    f0, mask and formant slices as goofer_tpu's UI."""
    ours, played, (a, b) = _play(gui, monkeypatch)
    theirs, _, span = _play(j_gui, monkeypatch)
    assert len(ours) == len(theirs) == 1 and span == (a, b)
    for x, y in zip(ours[0][:3], theirs[0][:3]):
        np.testing.assert_array_equal(x, y)
    assert sorted(ours[0][3]) == sorted(theirs[0][3])
    for k in ours[0][3]:
        np.testing.assert_array_equal(ours[0][3][k], theirs[0][3][k])
    assert ours[0][0].shape == (64, -(-b // 256) - a // 256)
    assert ours[0][5] == (1024, 256)
    assert len(played) == 1 and played[0][1] == SR
    assert len(played[0][0]) == b - a


def test_play_slices_features_at_the_ui_hop(tkpatch, monkeypatch):
    """The UI slices at the hop it is given (goofer_tpu hard-codes 256)
    and passes the hop and device on to the preview."""
    calls, played, (a, b) = _play(gui, monkeypatch, hop=128, tframes=64)
    env_seg, f0_seg, _, forms_seg, _, args, kw = calls[0]
    assert env_seg.shape == (64, -(-b // 128) - a // 128)
    assert forms_seg[1].shape == (env_seg.shape[1],)
    assert args == (1024, 128) and kw == {"device": "cpu"}
    assert len(f0_seg) == b - a and len(played[0][0]) == b - a


def test_play_without_features_plays_the_waveform(tkpatch, monkeypatch):
    played = []
    sd = type(sys)("sounddevice")
    sd.play = lambda y, sr: played.append(np.asarray(y))
    sd.stop = lambda: None
    monkeypatch.setitem(sys.modules, "sounddevice", sd)
    monkeypatch.setattr(gui, "_preview_synthesis", None)   # never called
    _, ui = _mk_ui(n=8000)
    fake_tk.find_button(ui.win, "Play").invoke()
    assert len(played) == 1 and len(played[0]) == 8000


# ------------------------------------------------------ .goofy batch mode

def _goofy(tmp_path, name, rng, n=6000, tframes=24, knots=False):
    p = tmp_path / f"{name}_features.goofy"
    env = (_knot_pack(rng, t=tframes) if knots
           else rng.random((513, tframes)).astype(np.float32) + 0.1)
    forms = {k: np.full(tframes, 700.0 * k) for k in (1, 2, 3, 4)}
    save_features(p, env, np.full(n, 200.0, np.float32),
                  np.ones(n, np.float32), forms, SR, n)
    return p


def _paint_scenario(x0, x1):
    def scenario(win):
        canvas = fake_tk.find_all(win, fake_tk.Canvas)[0]
        canvas.fire("<Button-3>", x=x0)
        canvas.fire("<B3-Motion>", x=x1)
        canvas.fire("<ButtonRelease-3>")
        fake_tk.find_button(win, "Apply").invoke()
    return scenario


def test_edit_goofy_files_writeback_equal_goofer_tpu(tkpatch, tmp_path):
    """Paint unvoiced and Apply: the port writes the same .goofy as
    goofer_tpu's batch editor (neighbour audio shown, no preview)."""
    n = 6000
    written = []
    for name, mod in (("v", gui), ("w", j_gui)):
        p = _goofy(tmp_path, name, np.random.default_rng(7))
        write_wav(tmp_path / f"{name}.wav",
                  np.sin(np.linspace(0, 60 * np.pi, n)) * 0.3, SR)
        fake_tk.push_scenario(_paint_scenario(200, 400))
        kw = {"device": "cpu"} if mod is gui else {}
        mod.edit_goofy_files([str(p)], **kw)
        written.append(load_features(p))
    _same_features(*written)
    _, f0r, maskr, _, srr, ylenr = written[0]
    assert srr == SR and ylenr == n
    a, b = _span(200, 400, n=n)
    assert (maskr[a:b] == 0).all()
    assert (maskr[:a] == 1).all() and (maskr[b:] == 1).all()
    assert (f0r[a:b] == 0).all()
    assert (f0r[:a] == 120.0).all() and (f0r[b:] == 120.0).all()


def test_edit_goofy_files_cancel_and_skips(tkpatch, tmp_path):
    p = _goofy(tmp_path, "u", np.random.default_rng(8))
    before = p.read_bytes()
    fake_tk.push_scenario(
        lambda win: fake_tk.find_button(win, "Cancel").invoke())
    gui.edit_goofy_files([str(p)], device="cpu")
    assert p.read_bytes() == before
    gui.edit_goofy_files([str(tmp_path / "missing.goofy"),
                          str(tmp_path / "u.wav")], device="cpu")
    assert sorted(x.name for x in tmp_path.iterdir()) == [p.name]


def test_edit_goofy_files_knots_without_audio(tkpatch, tmp_path,
                                              monkeypatch):
    """A knot-mode .goofy with no audio beside it: the envelope is decoded
    on the device and the UI shows the preview synthesis of the file."""
    p = _goofy(tmp_path, "k", np.random.default_rng(9), knots=True)
    seen = {}
    real_ui = gui.VoicingEditorUI

    def spy(*args, **kw):
        ui = real_ui(*args, **kw)
        seen.update(y=ui.y, features=ui.features, hop=ui.hop,
                    device=ui.device)
        return ui

    monkeypatch.setattr(gui, "VoicingEditorUI", spy)
    fake_tk.push_scenario(_paint_scenario(0, 800))
    gui.edit_goofy_files([str(p)], device="cpu")
    pack = load_features(p)[0]
    want = decode_env_from_knots(
        torch.as_tensor(pack["knot_vals_log"].astype(np.float32)),
        pack["sr"], pack["n_fft"], pack["n_bins"]).numpy()
    np.testing.assert_array_equal(seen["features"][0], want)
    assert seen["y"].shape == (6000,) and np.abs(seen["y"]).max() > 0
    assert seen["hop"] == 256 and seen["device"].type == "cpu"
    _, f0r, maskr, _, _, _ = load_features(p)
    assert (maskr == 0).all() and (f0r == 0).all()


def test_cli_goofy_editor_mode(tkpatch, tmp_path, cpu):
    p = tmp_path / "n_features.goofy"
    save_features(p, np.ones((513, 16), np.float32),
                  np.full(4000, 150.0, np.float32), np.ones(4000, np.float32),
                  {}, SR, 4000)
    fake_tk.push_scenario(_paint_scenario(0, 800))
    assert cli.main([str(p)]) == 0
    _, f0r, maskr, _, _, _ = load_features(p)
    assert (maskr == 0).all() and (f0r == 0).all()


def test_cli_goofy_editor_mode_needs_the_device(tkpatch, tmp_path,
                                                monkeypatch):
    """Without CUDA and without the CPU asked for, the mode fails."""
    monkeypatch.delenv("GOOFER_TPU_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = _goofy(tmp_path, "d", np.random.default_rng(1))
    before = p.read_bytes()
    assert cli.main([str(p)]) == 1
    assert p.read_bytes() == before


def test_preview_needs_the_device(monkeypatch):
    """Without CUDA and without the CPU asked for, the preview raises; it
    never falls back to the CPU."""
    monkeypatch.delenv("GOOFER_TPU_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    n = 2000
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gui._preview_synthesis(np.ones((513, 8), np.float32),
                               np.full(n, 150.0), np.ones(n), {}, SR)


# ----------------------------------------------------------- SE1 round trip

@pytest.fixture
def voice(tmp_path, cpu):
    """The vendored voice source in ``bank/``, renders go to ``cache/``
    (UTAU's layout), beside two stale renders of the source."""
    bank, cache = tmp_path / "bank", tmp_path / "cache"
    bank.mkdir()
    cache.mkdir()
    shutil.copy(VOICE / "src.wav", bank / "v.wav")
    shutil.copy(VOICE / "src_features.goofy", bank / "v_features.goofy")
    for name in ("v_1.wav", "v_2.wav", "other.wav"):
        (cache / name).write_bytes(b"stale")
    return bank / "v.wav", cache


def _scripted_hook(calls):
    def hook(y_snip, sr, init_mask):
        calls.append((len(y_snip), sr, init_mask.copy()))
        edited = init_mask.copy()
        edited[: len(edited) // 2] = 0.0
        return edited
    return hook


def _check_edit(src, cache, calls, before):
    """The hook ran once on the note's snippet, the .goofy's mask changed
    in the snippet's first half only, and the source's renders went."""
    assert len(calls) == 1
    n_snip, sr, init_mask = calls[0]
    assert sr == SR and n_snip == len(init_mask) > 0
    mask = load_features(src.with_name("v_features.goofy"))[2]
    changed = np.flatnonzero(mask != before)
    assert changed.size and np.all(mask[changed] == 0.0)
    assert changed.max() < n_snip // 2        # the cut starts at offset 0
    assert sorted(p.name for p in cache.iterdir()) == ["other.wav",
                                                       "out.wav"]


def test_se1_cli_round_trip(voice, monkeypatch):
    src, cache = voice
    before = load_features(src.with_name("v_features.goofy"))[2]
    calls = []
    monkeypatch.setattr(gui, "available_interactive_hook",
                        lambda: _scripted_hook(calls))
    out = cache / "out.wav"
    note = list(NOTE)
    note[2] = "SE1"
    assert cli.main([str(src), str(out)] + note) == 0
    _check_edit(src, cache, calls, before)
    # the note renders from the edited features
    fresh = src.parent.parent / "fresh"
    fresh.mkdir()
    shutil.copy(src.with_name("v_features.goofy"),
                fresh / "f_features.goofy")
    GooferResampler(fresh / "f.wav", fresh / "want.wav", *note,
                    device="cpu")
    np.testing.assert_array_equal(wavfile.read(out)[1],
                                  wavfile.read(fresh / "want.wav")[1])


def test_se1_headless_renders_unedited(voice, monkeypatch, caplog):
    src, cache = voice
    before = src.with_name("v_features.goofy").read_bytes()
    monkeypatch.setattr(gui, "available_interactive_hook", lambda: None)
    note = list(NOTE)
    note[2] = "SE1"
    assert cli.main([str(src), str(cache / "out.wav")] + note) == 0
    assert src.with_name("v_features.goofy").read_bytes() == before
    assert "no editor is available" in caplog.text


def test_note_after_an_edit_sees_the_edit(voice):
    """An edit within one mtime tick of the .goofy's last write: the next
    note must not be served the memoized old voicing."""
    src, cache = voice
    feat = src.with_name("v_features.goofy")
    first = cache / "first.wav"
    GooferResampler(src, first, *NOTE, device="cpu")
    tick = feat.stat().st_mtime_ns
    note = list(NOTE)
    note[2] = "SE1"
    GooferResampler(src, cache / "se.wav", *note, device="cpu",
                    editor_hook=_scripted_hook([]))
    os.utime(feat, ns=(tick, tick))          # a coarse filesystem's clock
    again = cache / "again.wav"
    GooferResampler(src, again, *NOTE, device="cpu")
    fresh = src.parent.parent / "fresh"
    fresh.mkdir()
    shutil.copy(feat, fresh / "f_features.goofy")
    GooferResampler(fresh / "f.wav", fresh / "want.wav", *NOTE,
                    device="cpu")
    got = wavfile.read(again)[1]
    np.testing.assert_array_equal(got, wavfile.read(fresh / "want.wav")[1])
    assert not np.array_equal(got, wavfile.read(first)[1])


def test_se1_through_the_server_handler(voice, monkeypatch):
    src, cache = voice
    before = load_features(src.with_name("v_features.goofy"))[2]
    calls = []
    monkeypatch.setattr(gui, "available_interactive_hook",
                        lambda: _scripted_hook(calls))
    httpd = server.ThreadedHTTPServer(("127.0.0.1", 0), server.RequestHandler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        note = list(NOTE)
        note[2] = "SE1"
        body = " ".join([str(src), str(cache / "out.wav")] + note)
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}",
            data=body.encode(), method="POST")
        with urllib.request.urlopen(req, timeout=600) as resp:
            assert resp.status == 200
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)
    assert not t.is_alive()
    _check_edit(src, cache, calls, before)


def test_forget_features_drops_only_that_source(voice):
    src, _ = voice
    feat = src.with_name("v_features.goofy")
    resampler.acquire_features(src, 1024, 256, torch.device("cpu"))
    other = ("elsewhere_features.goofy", 0, 1024, 256)
    with resampler._decoded_lock:
        resampler._decoded_cache[other] = ()
        assert any(k[0] == str(feat) for k in resampler._decoded_cache)
    resampler.forget_features(feat)
    with resampler._decoded_lock:
        keys = list(resampler._decoded_cache)
        del resampler._decoded_cache[other]
    assert other in keys and not any(k[0] == str(feat) for k in keys)


# --------------------------------------------------------------- preview

@pytest.fixture(scope="module")
def previews():
    """One span (n = 6000) of the voice source previewed by both packages,
    goofer_tpu at seeds 0 and 1 (one JAX compile), with the stems of each
    synth call."""
    import jax

    import goofer_tpu.engine.synth as j_synth
    import goofer_tpu_torch.engine.synth as synth

    env, f0, mask, forms, sr, _ = load_features(
        VOICE / "src_features.goofy")
    dense = decode_env_from_knots(
        torch.as_tensor(env["knot_vals_log"].astype(np.float32)),
        env["sr"], env["n_fft"], env["n_bins"]).numpy()
    a, b, hop = 30000, 36000, 256
    frames = slice(a // hop, -(-b // hop))
    args = (dense[:, frames], f0[a:b], mask[a:b],
            {k: np.asarray(v)[frames] for k, v in forms.items()}, sr)
    stems = {}

    def capture(module, name, key):
        real = module.synthesize

        def wrapped(*a_, **kw):
            if key is not None:
                kw["key"] = key
            out = real(*a_, **kw)
            stems[name] = [np.asarray(x) for x in out]
            return out
        return wrapped

    runs = {
        "ours": (synth, None,
                 lambda: gui._preview_synthesis(*args, device="cpu")),
        "theirs": (j_synth, None, lambda: j_gui._preview_synthesis(*args)),
        "theirs_seed1": (j_synth, jax.random.PRNGKey(1),
                         lambda: j_gui._preview_synthesis(*args)),
    }
    out = {}
    for name, (module, key, run) in runs.items():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(module, "synthesize", capture(module, name, key))
            out[name] = run()
    return out, stems, sr, b - a


def test_preview_within_lsd_budget(previews):
    """The preview (noisy stems included) within max(1 dB, goofer_tpu's own
    seed-to-seed LSD + 0.5 dB), outside goofer_tpu's attenuated last
    n_fft samples."""
    out, _, sr, n = previews
    ours, theirs, other = out["ours"], out["theirs"], out["theirs_seed1"]
    assert ours.shape == theirs.shape == (n,) and ours.dtype == np.float32
    assert np.isfinite(ours).all() and np.abs(ours).max() > 1e-3
    keep = n - 1024
    floor = lsd_db(other[:keep], theirs[:keep], sr)
    lsd = lsd_db(ours[:keep], theirs[:keep], sr)
    assert lsd <= max(1.0, floor + 0.5), (lsd, floor)


def test_preview_harmonic_stem_equal_goofer_tpu(previews):
    """The harmonic stem of the same synth call within 5e-3 x peak outside
    the last n_fft samples.  Each package's peak normalization divides
    by the peak of its noisy mix, whose noise streams differ, so each stem
    is held at unit peak over the compared span."""
    _, stems, _, n = previews
    keep = n - 1024
    ours = stems["ours"][1][:keep]
    theirs = stems["theirs"][1][:n][:keep]
    ours = ours / np.abs(ours).max()
    theirs = theirs / np.abs(theirs).max()
    assert np.abs(ours - theirs).max() <= 5e-3
    assert len(stems["ours"][1]) == n          # exact length, no bucket
