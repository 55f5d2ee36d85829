"""The port's feature extraction, .goofy writing, folder mode and the
slice as a whole (WAV in, WAV out, no .goofy from JAX) vs goofer_tpu on
the CPU.

Tolerances: the dense envelope within 1e-4 x peak (two FFT libraries in
float32); f0 and the voicing mask equal at the .goofy's float16 on
>= 99.9% of samples (the per-sample lerp rounds differently in the last
float32 bit); formants within 1 Hz on >= 99% of entries; the same K and
knots to one float16 step; renders from either package's features within
the parity suite's deterministic budget (5e-3 x peak off pulse windows
whose onset may land a sample off, 0.1 dB smoothed LSD)."""
import pytest

torch = pytest.importorskip("torch")

import shutil  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from goofer_tpu.analysis import features as j_features  # noqa: E402
from goofer_tpu.io import goofy as j_goofy  # noqa: E402
from goofer_tpu_torch import cli  # noqa: E402
from goofer_tpu_torch.analysis import features  # noqa: E402
from goofer_tpu_torch.io import goofy  # noqa: E402
from goofer_tpu_torch.sampler import batch_extract, render_core  # noqa: E402
from goofer_tpu_torch.sampler.resampler import (  # noqa: E402
    GooferResampler,
    acquire_features,
)
from goofer_tpu_torch.utils.audio_io import (  # noqa: E402
    is_audio_file,
    read_wav,
    read_wav_mono,
    write_wav,
)
from goofer_tpu_torch.utils.metrics import lsd_db  # noqa: E402
from tests.test_batch_extract import _tone  # noqa: E402
from tests.test_resample_oracle import (  # noqa: E402
    _flip_exclusion_mask,
    _layer_f0s,
)

SR = 44100
REF = Path(__file__).parent / "golden" / "ref"
NEUTRAL = ["C4", "100", "", "0", "500", "60", "0", "100", "0", "!120", "AA"]


@pytest.fixture(scope="module")
def ref_wave():
    y, sr = read_wav_mono(REF / "src.wav")
    assert sr == SR
    return y


@pytest.fixture(scope="module")
def ours(ref_wave):
    return features.extract_features(ref_wave, SR, device="cpu")


@pytest.fixture(scope="module")
def theirs(ref_wave):
    return j_features.extract_features(ref_wave.astype(np.float32), SR)


def _f16_equal_share(a, b):
    return float(np.mean(np.asarray(a, np.float16) == np.asarray(b,
                                                                 np.float16)))


def _formant_share(a, b, hz=1.0):
    return float(np.mean([np.mean(np.abs(np.asarray(a[k], np.float64)
                                         - np.asarray(b[k], np.float64))
                                  <= hz) for k in a]))


def _knots_within_a_step(a, b):
    a = np.asarray(a["knot_vals_log"]).astype(np.float32)
    b = np.asarray(b["knot_vals_log"]).astype(np.float32)
    assert a.shape == b.shape
    step = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float16))
    # a log-envelope near 0 has float16 steps finer than float32's
    # rounding of the log: 1e-6 there
    return bool((np.abs(a - b) <= np.maximum(step.astype(np.float32),
                                             1e-6)).all())


def test_extract_features_dense_matches_jax(ours, theirs, ref_wave):
    env, f0, mask, forms, knots = ours
    env_j, f0_j, mask_j, forms_j, knots_j = theirs
    n = len(ref_wave)
    assert env.shape == env_j.shape == (513, 1 + n // 256)
    assert env.dtype == np.float32
    assert np.abs(env - env_j).max() <= 1e-4 * env_j.max()
    assert f0.shape == (n,) and f0.dtype == np.float64
    assert mask.shape == (n,) and mask.dtype == np.float64
    assert _f16_equal_share(f0, f0_j) >= 0.999
    assert _f16_equal_share(mask, mask_j) >= 0.999
    assert set(forms) == set(forms_j) == {1, 2, 3, 4, 5}
    assert all(forms[k].shape == forms_j[k].shape for k in forms)
    assert _formant_share(forms, forms_j) >= 0.99
    assert _knots_within_a_step(knots, knots_j)
    np.testing.assert_array_equal(knots["hz_knots"], knots_j["hz_knots"])
    assert {k: knots[k] for k in ("mode", "n_bins", "n_fft", "sr")} == {
        k: knots_j[k] for k in ("mode", "n_bins", "n_fft", "sr")}


def test_extract_features_lean_equals_dense_payload(ours, ref_wave):
    """dense=False keeps the dense envelope on the device; what the
    .goofy stores is the same."""
    lean = features.extract_features(ref_wave, SR, dense=False, device="cpu")
    assert lean[0] is None
    assert np.array_equal(lean[1], ours[1]) and np.array_equal(lean[2],
                                                               ours[2])
    for k in ours[3]:
        assert np.array_equal(lean[3][k], ours[3][k])
    assert np.array_equal(lean[4]["knot_vals_log"], ours[4]["knot_vals_log"])
    lean_j = j_features.extract_features(ref_wave.astype(np.float32), SR,
                                         dense=False)
    assert _f16_equal_share(lean[1], lean_j[1]) >= 0.999
    assert _knots_within_a_step(lean[4], lean_j[4])


def test_extract_features_batch_rows_equal_files_alone():
    """Three files of different lengths, two padded lengths: each row of
    the batch equals the file alone, and goofer_tpu's extraction of it."""
    ys = [_tone(0.31, 200, seed=1), _tone(0.37, 170, seed=2),
          _tone(0.52, 240, seed=3)]
    rows = features.extract_features_batch(ys, SR, device="cpu")
    assert len({len(r[1]) for r in rows}) == 3
    for y, row in zip(ys, rows):
        alone = features.extract_features(y, SR, device="cpu")
        assert np.array_equal(row[0], alone[0])
        assert np.array_equal(row[1], alone[1])
        assert np.array_equal(row[2], alone[2])
        for k in alone[3]:
            assert np.array_equal(row[3][k], alone[3][k])
        assert np.array_equal(row[4]["knot_vals_log"],
                              alone[4]["knot_vals_log"])
    theirs = j_features.extract_features(ys[1], SR)
    assert np.abs(rows[1][0] - theirs[0]).max() <= 1e-4 * theirs[0].max()
    assert _f16_equal_share(rows[1][1], theirs[1]) >= 0.999
    assert _formant_share(rows[1][3], theirs[3]) >= 0.99
    assert _knots_within_a_step(rows[1][4], theirs[4])


def test_extraction_chunks_are_capped_by_files_and_frames():
    lengths = [20000] * 10 + [90000] * 5 + [60 * SR]
    plan = list(features.chunk_plan(lengths, 256, 4, 1000))
    assert sorted(i for _, part in plan for i in part) == list(range(16))
    for n_pad, part in plan:
        assert len(part) <= 4
        assert len(part) == 1 or len(part) * (n_pad // 256 + 2) <= 1000
        assert all(lengths[i] + 8 * 256 <= n_pad for i in part)
    assert [len(p) for _, p in plan] == [4, 4, 2, 2, 2, 1, 1]


def test_extraction_non_standard_sample_rate():
    sr = 22050
    n = int(0.4 * sr)
    t = np.arange(n) / sr
    # two sines over a noise floor: without one, the LPC poles beside the
    # sines fit rounding noise and no two implementations agree on them
    y = (0.4 * np.sin(2 * np.pi * 220.0 * t)
         + 0.1 * np.sin(2 * np.pi * 440.0 * t)
         + 0.01 * np.random.default_rng(0).standard_normal(n)).astype(
             np.float32)
    (res,) = features.extract_features_batch([y], sr, dense=False,
                                             device="cpu")
    env, f0, mask, forms, knots = res
    assert env is None
    voiced = f0[mask > 0]
    assert len(voiced) > n // 2
    assert abs(float(np.median(voiced)) - 220.0) < 10.0
    assert knots["sr"] == sr
    (res_j,) = j_features.extract_features_batch([y], sr, dense=False)
    assert _f16_equal_share(f0, res_j[1]) >= 0.999
    assert _formant_share(forms, res_j[3]) >= 0.99


def test_from_jax_features_is_the_ports_form(ours, theirs):
    moved = features.from_jax_features(theirs)
    for a, b in zip(moved[:3], ours[:3]):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert {k: v.dtype for k, v in moved[3].items()} == {
        k: v.dtype for k, v in ours[3].items()}
    assert moved[4]["knot_vals_log"].dtype == np.float16
    assert features.from_jax_features((None,) + tuple(theirs[1:]))[0] is None


# ------------------------------------------------------------------ .goofy

def test_goofy_written_by_the_port_loads_in_jax(tmp_path, ours, ref_wave):
    _, f0, mask, forms, knots = ours
    path = tmp_path / "a_features.goofy"
    goofy.save_features_atomic(path, knots, f0, mask, forms, SR,
                               len(ref_wave))
    assert not Path(str(path) + ".tmp").exists()
    a = j_goofy.load_features(path)
    b = goofy.load_features(path)
    assert a[4:] == b[4:] == (SR, len(ref_wave))
    assert np.array_equal(a[0]["knot_vals_log"], knots["knot_vals_log"])
    for x, y in zip(a[1:3], b[1:3]):
        assert np.array_equal(x, y)
    assert np.array_equal(a[1], f0.astype(np.float16).astype(np.float32))
    assert sorted(a[3]) == [1, 2, 3, 4]
    assert np.array_equal(a[3][2], forms[2])


def test_goofy_written_by_jax_loads_in_the_port(tmp_path, theirs, ref_wave):
    env, f0, mask, forms, knots = theirs
    for name, payload in (("knots", knots), ("full", env)):
        path = tmp_path / f"{name}_features.goofy"
        j_goofy.save_features(path, payload, f0, mask, forms, SR,
                              len(ref_wave))
        a = goofy.load_features(path)
        b = j_goofy.load_features(path)
        assert a[4:] == b[4:]
        if name == "knots":
            assert np.array_equal(a[0]["knot_vals_log"],
                                  b[0]["knot_vals_log"])
        else:
            assert np.array_equal(a[0], b[0])
        assert np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
        # and the port's writer stores the same arrays
        again = tmp_path / f"{name}_again.goofy"
        goofy.save_features(again, payload, f0, mask, forms, SR,
                            len(ref_wave))
        c = j_goofy.load_features(again)
        assert np.array_equal(c[1], b[1]) and np.array_equal(c[3][1],
                                                             b[3][1])


def test_pad_trim_to_len():
    assert goofy.pad_trim_to_len([1.0, 2.0], 4).tolist() == [1, 2, 2, 2]
    assert goofy.pad_trim_to_len([1.0, 2.0, 3.0], 2).tolist() == [1, 2]
    assert goofy.pad_trim_to_len([], 3).tolist() == [0, 0, 0]
    assert goofy.pad_trim_to_len([1, 2], 3).dtype == np.float64


# ------------------------------------------------------------- folder mode

def test_is_audio_file():
    from goofer_tpu.utils.audio_io import is_audio_file as j_is_audio_file

    assert is_audio_file("a/b.WAV") and is_audio_file(Path("x.wav"))
    for name in ("x.flac", "x.aiff", "x.AIF", "x.mp3", "x.goofy", "x"):
        assert is_audio_file(name) == j_is_audio_file(name), name
    assert is_audio_file("x.flac") and not is_audio_file("x.goofy")


def _bank(tmp_path):
    paths = []
    for i, dur in enumerate((0.31, 0.37, 0.44)):
        p = tmp_path / "sub" / f"v{i}.wav" if i == 2 else tmp_path / f"v{i}.wav"
        p.parent.mkdir(exist_ok=True)
        write_wav(p, _tone(dur, 200 + 20 * i), SR)
        paths.append(p)
    (tmp_path / "broken.wav").write_bytes(b"RIFFnope")
    (tmp_path / "notes.txt").write_text("not audio")
    return paths


def test_folder_extraction_end_to_end(tmp_path):
    paths = _bank(tmp_path)
    count = batch_extract.extract_features_recursive(tmp_path, device="cpu")
    assert count == 4           # the corrupt file is found, logged, skipped
    feats = [p.with_name(f"{p.stem}_features.goofy") for p in paths]
    assert all(f.exists() for f in feats)
    assert not (tmp_path / "broken_features.goofy").exists()

    # second run: everything cached, nothing re-extracted
    before = [f.stat().st_mtime_ns for f in feats]
    batch_extract.extract_features_recursive(tmp_path, device="cpu")
    assert before == [f.stat().st_mtime_ns for f in feats]

    env, f0i, vmask, forms, sr, ylen = j_goofy.load_features(feats[0])
    assert sr == SR and ylen == int(0.31 * SR) and len(f0i) == ylen
    assert env["knot_vals_log"].shape[1] == 1 + ylen // 256
    # what the folder wrote is what the file alone extracts to
    y, _ = read_wav_mono(paths[0])
    alone = features.extract_features(y, SR, dense=False, device="cpu")
    assert np.array_equal(f0i, alone[1].astype(np.float16).astype(np.float32))
    assert np.array_equal(env["knot_vals_log"], alone[4]["knot_vals_log"])


def test_process_file(tmp_path):
    p = tmp_path / "one.wav"
    write_wav(p, _tone(0.31, 210), SR)
    assert batch_extract.process_file(p, device="cpu") is True
    assert (tmp_path / "one_features.goofy").exists()
    assert batch_extract.process_file(p, device="cpu") is False   # [SKIP]
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFFnope")
    assert batch_extract.process_file(bad, device="cpu") is False


def test_folder_extraction_surfaces_analysis_errors(tmp_path, monkeypatch):
    """An error of the analysis is raised, not retried file by file."""
    _bank(tmp_path)

    def boom(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(features, "analyze_chunk", boom)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        batch_extract.extract_features_recursive(tmp_path, device="cpu")
    assert not list(tmp_path.rglob("*.goofy"))
    monkeypatch.setenv("GOOFER_TPU_TORCH_DEVICE", "cpu")
    assert cli.main([str(tmp_path)]) == 1


def test_cli_folder_mode(tmp_path, monkeypatch):
    monkeypatch.setenv("GOOFER_TPU_TORCH_DEVICE", "cpu")
    paths = _bank(tmp_path)
    assert cli.main([str(tmp_path)]) == 0
    assert len(list(tmp_path.rglob("*_features.goofy"))) == len(paths)
    assert cli.main([str(paths[0])]) == 0          # one file: skipped


# ------------------------------------------------------ the slice as a whole

def test_cli_renders_a_source_without_goofy(tmp_path, monkeypatch):
    """WAV in, WAV out: the first render extracts and saves the .goofy,
    goofer_tpu reads it, and the output is within the golden's budget."""
    monkeypatch.setenv("GOOFER_TPU_TORCH_DEVICE", "cpu")
    src = tmp_path / "src.wav"
    shutil.copy(REF / "src.wav", src)
    out = tmp_path / "out.wav"
    assert cli.main([str(src), str(out)] + NEUTRAL) == 0
    feat = tmp_path / "src_features.goofy"
    assert feat.exists() and out.exists()
    env, f0i, vmask, forms, sr, ylen = j_goofy.load_features(feat)
    assert sr == SR and ylen == 26460 and env["mode"] == "knots"
    ours, _ = read_wav(out)
    golden, _ = read_wav(REF / "out_neutral.wav")
    assert len(ours) == len(golden) and np.isfinite(ours).all()
    # tests/test_golden.py's budget: seed-to-seed floor + 0.5 dB
    assert lsd_db(np.float32(ours), np.float32(golden), SR) <= 0.76 + 0.5
    # the second render loads the cache
    stamp = feat.stat().st_mtime_ns
    assert cli.main([str(src), str(out)] + NEUTRAL) == 0
    assert feat.stat().st_mtime_ns == stamp


def test_acquire_features_extracts_then_loads(tmp_path):
    src = tmp_path / "src.wav"
    shutil.copy(REF / "src.wav", src)
    dev = torch.device("cpu")
    fresh = acquire_features(src, 1024, 256, dev)
    assert (tmp_path / "src_features.goofy").exists()
    cached = acquire_features(src, 1024, 256, dev)
    assert acquire_features(src, 1024, 256, dev) is cached   # memoized
    assert acquire_features(src, 1024, 128, dev) is not cached
    assert fresh[0].shape == cached[0].shape and fresh[4:] == cached[4:]
    # the cache stores 192 mel knots: the decoded envelope follows the
    # dense one where the envelope carries energy
    loud = fresh[0] > 1e-3 * fresh[0].max()
    assert np.median(np.abs(np.log(cached[0][loud] / fresh[0][loud]))) < 0.05
    assert _f16_equal_share(fresh[1], cached[1]) == 1.0


def _render_quiet(feats, flags="P0"):
    """The port's render of one note from extracted features, noise stems
    zeroed; returns (waveform, per-sample f0, mask, RenderStatic)."""
    env, f0, mask, forms, _ = feats
    r = GooferResampler("/tmp/nonexistent.wav", "/dev/null", "C4", 100,
                        flags, 0, 500, 60, 0, 100, 0, "!120", "AA",
                        device="cpu", autorender=False)
    rs, arrays, scalars = r.prepare(env, f0, mask, forms, SR, len(f0))
    scalars = dict(scalars, uv_strength=0.0, breath_strength=0.0)
    out = render_core.render_note(rs, arrays, scalars, 0, "cpu").numpy()
    rs_t, tensors, sc_t, _ = render_core.from_jax_plan(rs, arrays, scalars,
                                                       "cpu")
    _, f0_n, mask_n = render_core.assemble_f0_mask(
        rs_t, tensors["f0_cut"], tensors["mask_cut"], None,
        tensors["pitch_ticks"], sc_t)
    return out, f0_n[0].numpy(), mask_n[0].numpy()


def test_render_from_either_packages_extraction(ours, ref_wave):
    """The slice end to end, deterministic: one note rendered by the port
    from its own extraction and from goofer_tpu's (the path a fresh
    source takes there, a bucketed batch of one)."""
    theirs = features.from_jax_features(j_features.extract_features_batch(
        [ref_wave.astype(np.float32)], SR)[0])
    out_t, f0_t, mask_t = _render_quiet(ours)
    out_j, f0_j, mask_j = _render_quiet(theirs)
    assert out_t.shape == out_j.shape and np.isfinite(out_t).all()
    n = len(out_j)
    keep = _flip_exclusion_mask(
        _layer_f0s(f0_t, mask_t, False, False, SR, None),
        _layer_f0s(f0_j, mask_j, False, False, SR, None), f0_j, SR, n)
    assert keep.mean() > 0.85
    peak = float(np.abs(out_j).max() + 1e-12)
    assert (np.abs(out_t - out_j)[keep] / peak).max() <= 5e-3
    assert lsd_db(out_t, out_j, SR) < 0.1
