"""The port's mesh layer (goofer_tpu_torch/parallel/) on the CPU.

Meshes here repeat ``torch.device("cpu")``: every slot's shard runs in
turn in the caller's thread, as the slots of a mesh that repeats one card
do.

* The tp-sharded knot decode is bit-equal to
  ``decode_log_env_from_knots`` for any K and tp, and within 1e-5 of
  goofer_tpu's dense ``_decode_matrix`` product (float32 roundings of
  log-envelopes of size <= ~20).
* Sharded renders against the same rows rendered on one device: a row's
  features and noise do not depend on its shard, but the CPU's FFT and
  convolution round a row differently in the last bits at another batch
  size, so rows are held to the phrase's row-vs-note-alone budget
  (tests/test_torch_phrase.py): 5e-3 x peak and 0.1 dB LSD.  The sharded
  extraction is bit-equal, as a padded extraction row is to the file
  alone.
* Against goofer_tpu on its 8-device virtual CPU mesh
  (tests/conftest.py): the sharded extraction with
  tests/test_torch_extract.py's tolerances, the sharded note render with
  test_batched_core_matches_jax_vmap's.
"""
import shutil
import subprocess
import sys
import threading
from functools import partial
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from goofer_tpu import parallel as j_parallel  # noqa: E402
from goofer_tpu.analysis import features as j_features  # noqa: E402
from goofer_tpu.ops import envelope as j_envelope  # noqa: E402
from goofer_tpu.sampler.phrase import ARRAY_ORDER as J_ARRAY_ORDER  # noqa: E402
from goofer_tpu.sampler.render_core import (  # noqa: E402
    default_scalars as j_default_scalars,
)
from goofer_tpu.sampler.resampler import (  # noqa: E402
    GooferResampler as JaxResampler,
)
from goofer_tpu.utils.metrics import lsd_db  # noqa: E402
from goofer_tpu_torch import config, devices  # noqa: E402
from goofer_tpu_torch.analysis import features  # noqa: E402
from goofer_tpu_torch.engine.synth import SynthStatic  # noqa: E402
from goofer_tpu_torch.io import goofy  # noqa: E402
from goofer_tpu_torch.ops.cuda import (  # noqa: E402
    _build,
    burg_kernel,
    cascade_kernel,
    lpc_roots_kernel,
    pulse_kernel,
    viterbi_kernel,
)
from goofer_tpu_torch.ops.envelope import (  # noqa: E402
    _knot_bin_idx,
    decode_env_from_knots,
    decode_log_env_from_knots,
)
from goofer_tpu_torch.parallel import (  # noqa: E402
    batch,
    dryrun,
    make_mesh,
    pad_note_batch,
    render_batch,
    render_batch_sharded,
    render_notes_sharded,
)
from goofer_tpu_torch.sampler import (  # noqa: E402
    batch_extract,
    phrase,
    render_core,
)
from goofer_tpu_torch.sampler.phrase import NoteSpec  # noqa: E402
from goofer_tpu_torch.utils.audio_io import write_wav  # noqa: E402
from tests.test_batch_extract import _tone  # noqa: E402
from tests.test_resample_oracle import (  # noqa: E402
    _device_f0_mask,
    _flip_exclusion_mask,
)
from tests.test_torch_extract import (  # noqa: E402
    _f16_equal_share,
    _formant_share,
    _knots_within_a_step,
)

SR = 44100
CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
VOICE = Path(__file__).parent / "golden" / "voice"
HEAVY = "sh30sr30sg40su40sj20st-30vf40es30pd40fw20fsta50"


def cpu_mesh(n=8, tp=2):
    return make_mesh(n, tp=tp, devices=[CPU] * n)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread for this module: the suite runs 6
    workers beside JAX's own thread pools, and torch's default of one
    thread per core oversubscribes the machine; the old count comes back
    at teardown."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_parallel_vb")
    shutil.copy(VOICE / "src.wav", d / "a.wav")
    shutil.copy(VOICE / "src_features.goofy", d / "a_features.goofy")
    return str(d / "a.wav")


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _row_budget(got, want, n_fft=1024, hop=256):
    """The phrase's row-vs-note-alone budget."""
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel(got, want) <= 5e-3
    assert lsd_db(got, want, SR, n_fft, hop) < 0.1


# ---- meshes -------------------------------------------------------------

def test_make_mesh_shapes_and_errors():
    m = cpu_mesh()
    assert m.devices.shape == (4, 2) and m.size == 8
    assert m.shape == {"dp": 4, "tp": 2} and m.axis_names == ("dp", "tp")
    assert m.slots == [CPU] * 8
    m = make_mesh(devices=["cpu"] * 3)
    assert m.devices.shape == (3, 1) and m.shape["tp"] == 1
    m = make_mesh(2, axis_names=("a", "b"), devices=[CPU] * 5)
    assert m.shape == {"a": 2, "b": 1}
    with pytest.raises(ValueError, match="tp=3 does not divide"):
        make_mesh(8, tp=3, devices=[CPU] * 8)
    with pytest.raises(RuntimeError, match="9 devices asked for, 8"):
        make_mesh(9, devices=[CPU] * 8)


def test_make_mesh_without_a_card_raises(monkeypatch):
    """Without ``devices`` the mesh is the machine's cards: none, or
    fewer than asked, raises, whatever $GOOFER_TPU_TORCH_DEVICE says."""
    monkeypatch.setenv(config.DEVICE_ENV, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.dryrun_multichip(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert make_mesh().slots == [torch.device("cuda", 0)]
    with pytest.raises(RuntimeError, match="2 devices asked for, 1"):
        make_mesh(2)


@pytest.mark.parametrize("n,parts,want", [
    (8, 8, [(i, i + 1) for i in range(8)]),
    (5, 8, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 5), (5, 5),
            (5, 5)]),
    (10, 4, [(0, 3), (3, 6), (6, 8), (8, 10)]),
    (0, 2, [(0, 0), (0, 0)]),
])
def test_shard_bounds(n, parts, want):
    assert devices.shard_bounds(n, parts) == want


def test_run_on_slots_orders_results_and_raises():
    """One worker thread per distinct device with tasks, the three at
    once (each first task waits for the other two), each running its
    slots' tasks in slot order; a worker's exception reaches the
    caller."""
    devs = [CPU, torch.device("cpu", 0), torch.device("meta")]
    slots = [devs[0], devs[1], devs[0], devs[2], devs[1], devs[0]]
    together = threading.Barrier(3, timeout=30)
    ran = []

    def task(slot, j):
        if j == 0 and slot in (0, 1, 3):
            together.wait()
        ran.append((str(slots[slot]), threading.get_ident(), slot, j))
        return slot, j

    tasks = [[lambda s=s, j=j: task(s, j) for j in range(3)] if s != 2
             else [] for s in range(6)]
    out = devices.run_on_slots(slots, tasks)
    assert out == [[(s, j) for j in range(3)] if s != 2 else []
                   for s in range(6)]
    threads = {d: {t for name, t, _, _ in ran if name == d}
               for d in map(str, devs)}
    assert all(len(ids) == 1 for ids in threads.values())
    assert len(set.union(*threads.values())) == 3
    for d in map(str, devs):
        assert [(s, j) for name, _, s, j in ran if name == d] == sorted(
            (s, j) for s in range(6) if s != 2 and str(slots[s]) == d
            for j in range(3))

    def boom():
        raise RuntimeError("kernel launch failed: CUDA error 700")

    with pytest.raises(RuntimeError, match="CUDA error 700"):
        devices.run_on_slots(slots[:4], [[boom], [lambda: 1], [],
                                                  [boom]])


def test_run_on_slots_one_device_runs_inline():
    """Slots that all name one device run in the caller's thread, slot by
    slot in order, with no worker thread."""
    ran = []

    def task(slot):
        ran.append((threading.get_ident(), slot))
        return slot

    tasks = [[partial(task, s)] * 2 if s != 1 else [] for s in range(4)]
    assert devices.run_on_slots([CPU] * 4, tasks) == [
        [0, 0], [], [2, 2], [3, 3]]
    assert ran == [(threading.get_ident(), s) for s in (0, 0, 2, 2, 3, 3)]
    assert devices.run_on_slots([CPU] * 4, [[], [], [], []]) == [
        [], [], [], []]


def test_analysis_does_not_load_the_mesh_layer():
    """The extractor splits its chunks through goofer_tpu_torch.devices,
    a leaf module: importing it loads neither parallel/ nor the note
    render."""
    code = ("import sys\n"
            "import goofer_tpu_torch.analysis.features\n"
            "import goofer_tpu_torch.sampler.batch_extract\n"
            "bad = sorted(m for m in sys.modules if m.startswith(\n"
            "    ('goofer_tpu_torch.parallel', "
            "'goofer_tpu_torch.sampler.render_core')))\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.mark.parametrize("wrapper", [
    pulse_kernel.pulse_accumulate, cascade_kernel.one_pole_cascade,
    viterbi_kernel.pitch_viterbi, lpc_roots_kernel.lpc_roots,
    burg_kernel.burg_lpc], ids=lambda w: w.__name__)
def test_launch_counter_counts_every_thread(wrapper):
    """8 threads x 1000 counts through the wrappers' counter, with the
    interpreter switching threads as often as it can: none is lost."""
    before = wrapper.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count_launch(wrapper) for _ in range(1000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches - before == 8000
    wrapper.launches = before


# ---- the batch and the tp decode ---------------------------------------

N_FFT_S, HOP_S = 512, 128
N_BINS_S = N_FFT_S // 2 + 1


def _note(n, f0_hz):
    t_frames = 1 + n // HOP_S
    env = (np.exp(-np.linspace(0, 5, N_BINS_S))[:, None]
           * (1 + 0.2 * np.sin(np.linspace(0, 9, t_frames)))[None, :]
           + 1e-5).astype(np.float32)
    f0 = np.full(n, f0_hz, dtype=np.float32)
    f0[: n // 10] = 0
    mask = (f0 > 75).astype(np.float32)
    tracks = np.zeros((4, t_frames), dtype=np.float32)
    return env, f0, mask, tracks


def test_pad_note_batch_matches_jax():
    rng = np.random.default_rng(0)
    envs, f0s, masks, tracks = [], [], [], []
    for n, t in ((300, 4), (512, 7), (100, 2)):
        envs.append(rng.random((9, t), dtype=np.float32))
        f0s.append(rng.random(n, dtype=np.float32) * 300)
        masks.append((rng.random(n) > 0.5).astype(np.float32))
        tracks.append(rng.random((4, t), dtype=np.float32) * 3000)
    got = pad_note_batch(envs, f0s, masks, tracks, device="cpu")
    want = j_parallel.pad_note_batch(envs, f0s, masks, tracks)
    for name in ("env", "f0", "mask", "tracks"):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.device == CPU and a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    np.testing.assert_array_equal(got.lengths, want.lengths)


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("k", [63, 64, 128])
def test_tp_decode_bit_equal(k, tp):
    """The tp members' partial log-envelopes, summed as reduce_to sums
    them, are decode_log_env_from_knots bit for bit."""
    rng = np.random.default_rng(k + tp)
    knots = torch.as_tensor(rng.normal(-4.0, 3.0, (3, k, 11)).astype(
        np.float16))
    want = decode_log_env_from_knots(knots, SR, 1024, 513)
    rows = batch.tp_log_env(cpu_mesh(tp, tp), knots, SR, 1024, 513)
    assert len(rows) == 1
    got = rows[0]
    assert got.dtype == torch.float32 and torch.equal(got, want)
    rows = batch.tp_log_env(make_mesh(3 * tp, tp=tp, devices=[CPU] * 3 * tp),
                            knots, SR, 1024, 513)
    assert [r.shape[0] for r in rows] == [1, 1, 1]
    assert torch.equal(torch.cat(rows), want)
    assert torch.equal(torch.exp(got),
                       decode_env_from_knots(knots, SR, 1024, 513))
    dense = np.einsum("nk,bkt->bnt", j_envelope._decode_matrix(SR, 1024, k),
                      knots.float().numpy())
    np.testing.assert_allclose(got.numpy(), dense, rtol=0, atol=1e-5)
    # a cut to fewer bins cuts every partial the same way
    part = batch.tp_partial_log_env(knots, 0, k, SR, 1024, 200)
    assert torch.equal(part, want[:, :200])


def _knot_notes(b, k, n=4096):
    notes = [_note(n, 150.0 + 40 * i) for i in range(b)]
    bin_idx = _knot_bin_idx(SR, N_FFT_S, k, N_BINS_S)
    knots = np.stack([np.log(np.maximum(env, 1e-8))[bin_idx, :]
                      for env, _, _, _ in notes])
    return notes, knots


@pytest.mark.parametrize("k", [63, 64])
def test_render_batch_sharded_matches_render_batch(k):
    """8 slots, dp 4 x tp 2: each row as render_batch renders it from the
    decoded envelope (the same key (seed, row)); a B that dp does not
    divide raises."""
    n = 4096
    notes, knots = _knot_notes(8, k, n)
    f0, mask, tracks = (np.stack([x[i] for x in notes]) for i in (1, 2, 3))
    st = SynthStatic(sr=SR, n_fft=N_FFT_S, hop=HOP_S, n=n)
    knobs = {"breath_strength": np.linspace(0.05, 0.4, 8)}
    got = render_batch_sharded(cpu_mesh(), st, knots, f0, mask, tracks,
                               knobs=knobs, seed=5)
    env = decode_env_from_knots(torch.as_tensor(knots), SR, N_FFT_S,
                                N_BINS_S)
    nb = pad_note_batch(list(env.numpy()), list(f0), list(mask),
                        list(tracks), device="cpu")
    want = render_batch(st, nb, knobs=knobs, seed=5)
    for g, w in zip(got, want):
        assert g.shape == (8, n) and g.device == CPU
    for i in range(8):
        _row_budget(got[0][i].numpy(), want[0][i].numpy(), N_FFT_S, HOP_S)
        _row_budget(got[1][i].numpy(), want[1][i].numpy(), N_FFT_S, HOP_S)
    # another seed is another realization of the noise
    other = render_batch(st, nb, knobs=knobs, seed=6)[0]
    assert _rel(other[0].numpy(), want[0][0].numpy()) > 1e-3
    with pytest.raises(ValueError, match="not divisible by the dp"):
        render_batch_sharded(cpu_mesh(), st, knots[:6], f0[:6], mask[:6],
                             tracks[:6])


def test_render_batch_matches_synthesize():
    """render_batch's row b is engine/synth.synthesize of the same note
    keyed (seed, b), the pitch shift applied to f0 first."""
    from goofer_tpu_torch.engine.synth import synthesize

    n = 3000
    notes = [_note(n, f) for f in (180.0, 260.0)]
    nb = pad_note_batch(*[[x[i] for x in notes] for i in range(4)],
                        device="cpu")
    st = SynthStatic(sr=SR, n_fft=N_FFT_S, hop=HOP_S, n=n)
    knobs = {"pitch_shift": np.float32(1.5)}
    mix = render_batch(st, nb, knobs=knobs, seed=2)[0]
    for b, (env, f0, mask, tracks) in enumerate(notes):
        alone = synthesize(st, env, f0, mask, tracks, knobs=knobs,
                           seed=(2, b), device="cpu")[0]
        _row_budget(mix[b].numpy(), alone.numpy(), N_FFT_S, HOP_S)


# ---- the note render and the phrase -------------------------------------

PHRASE_ROWS = [("C4", 300, "t10"), ("A3", 420, HEAVY), ("E4", 300, "B20"),
               ("C5", 420, HEAVY + "t10"), ("G3", 300, "t-30B-10"),
               ("D4", 350, "P0")]


def _notes(src, rows):
    return [NoteSpec(src, p, length=ln, consonant=60, flags=f)
            for p, ln, f in rows]


def test_render_phrase_on_a_mesh_matches_one_device(src):
    """Three groups (3 notes: a B that 8 slots do not divide; 2 heavy; 1
    note on 8 slots) on 8 slots and on 3 (3 and 2 of 3 rows per slot):
    every note as on one device, pcm16 int16 too."""
    notes = _notes(src, PHRASE_ROWS)
    planned, _ = phrase.plan_phrase(notes, device="cpu")
    assert sorted(len(m) for m in phrase.group_planned(planned).values()) \
        == [1, 2, 3]
    one = phrase.render_phrase(notes, seed=3, device="cpu")
    for m in (cpu_mesh(), make_mesh(devices=[CPU] * 3)):
        got = phrase.render_phrase(notes, seed=3, mesh=m)
        for a, b in zip(got, one):
            _row_budget(a, b)
    pcm = phrase.render_phrase(notes[:3], seed=3, pcm16=True,
                               mesh=cpu_mesh())
    pcm_one = phrase.render_phrase(notes[:3], seed=3, pcm16=True,
                                   device="cpu")
    for a, b in zip(pcm, pcm_one):
        assert a.dtype == np.int16 and a.shape == b.shape
        assert np.abs(a.astype(np.int32) - b).max() <= 2
    assert phrase.render_phrase(notes[:2], mesh=cpu_mesh(),
                                fetch=False) is None
    with pytest.raises(ValueError, match="device= or mesh="):
        phrase.render_phrase(notes[:1], device="cpu", mesh=cpu_mesh())


def test_render_phrase_mesh_never_falls_back(src, monkeypatch):
    """A mesh shard whose render fails raises; a mesh of the card without
    one raises."""
    notes = _notes(src, PHRASE_ROWS[:3])
    real = phrase.render_group

    def failing(rs, members, *args):
        if any(m.index == 2 for m in members):
            raise RuntimeError("pulse_accumulate kernel launch failed")
        return real(rs, members, *args)

    monkeypatch.setattr(phrase, "render_group", failing)
    with pytest.raises(RuntimeError, match="launch failed"):
        phrase.render_phrase(notes, mesh=cpu_mesh())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    card = make_mesh(devices=[torch.device("cuda", 0)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        phrase.render_phrase(notes, mesh=card)


def test_render_phrase_to_wavs_on_a_mesh(src, tmp_path, monkeypatch):
    from goofer_tpu_torch.utils.audio_io import read_wav

    monkeypatch.delenv(config.DEVICE_ENV, raising=False)
    notes = _notes(src, PHRASE_ROWS[:2])
    paths = [tmp_path / f"{i}.wav" for i in range(2)]
    outs = phrase.render_phrase_to_wavs(notes, paths, mesh=cpu_mesh(4))
    for o, p in zip(outs, paths):
        y, sr = read_wav(p)
        assert sr == SR and len(y) == len(o)


@pytest.mark.parametrize("rows", [
    PHRASE_ROWS[:1], [PHRASE_ROWS[0], PHRASE_ROWS[2], PHRASE_ROWS[4]] * 3,
    [PHRASE_ROWS[1], PHRASE_ROWS[3]] * 3], ids=["B1", "B9", "heavy-B6"])
def test_render_notes_sharded_matches_one_device(src, rows):
    """One group's notes on 8 slots as render_core renders the group on
    one device, each note keyed (seed, index)."""
    planned, _ = phrase.plan_phrase(_notes(src, rows), device="cpu")
    (rs, _), members = next(iter(phrase.group_planned(planned).items()))
    assert len(members) == len(rows)
    arrays = [m.arrays for m in members]
    scalars = [m.scalars for m in members]
    seeds = [(4, m.index) for m in members]
    got = render_notes_sharded(cpu_mesh(), rs, arrays, scalars, seeds)
    tensors, sc, keys = render_core.device_inputs(rs, arrays, scalars, seeds,
                                                  "cpu")
    want = render_core.render_note_core(
        rs, *(tensors[k] for k in render_core.ARRAY_KEYS), sc, keys)
    assert got.shape == want.shape == (len(rows), rs.n)
    for g, w in zip(got.numpy(), want.numpy()):
        _row_budget(g, w)


def test_render_notes_sharded_shares_arrays_per_shard(src, monkeypatch):
    """device_inputs runs once per shard, on the shard's notes, so an
    array every note shares goes to a shard's device once."""
    planned, _ = phrase.plan_phrase(
        _notes(src, [(p, 300, "t7") for p in ("C4", "E4", "G4", "A4")]),
        device="cpu")
    (rs, _), members = next(iter(phrase.group_planned(planned).items()))
    calls = []
    real = batch.device_inputs

    def spy(rs, arrays, *args):
        calls.append(len(arrays))
        out = real(rs, arrays, *args)
        if len(arrays) > 1:
            assert out[0]["env_cut"].stride(0) == 0
        return out

    monkeypatch.setattr(batch, "device_inputs", spy)
    render_notes_sharded(cpu_mesh(4, tp=2), rs, [m.arrays for m in members],
                         [m.scalars for m in members], [0, 1, 2, 3])
    assert sorted(calls) == [1, 1, 1, 1]
    calls.clear()
    render_notes_sharded(cpu_mesh(2, tp=1), rs, [m.arrays for m in members],
                         [m.scalars for m in members], [0, 1, 2, 3])
    assert calls == [2, 2]


# ---- against goofer_tpu's mesh -----------------------------------------

def _jax_small_group():
    """goofer_tpu plans of 8 notes of one exact geometry (tests/
    test_parallel.py's n_fft 256 / hop 64 note), two pitches and two flag
    sets in turns."""
    sr, n_fft, hop, ylen = SR, 256, 64, 4096
    n_bins = n_fft // 2 + 1
    t = ylen // hop + 1
    env = (np.exp(-np.linspace(0, 5, n_bins))[:, None]
           * (1 + 0.3 * np.sin(np.linspace(0, 7, t)))[None, :]
           + 1e-5).astype(np.float32)
    f0i = 220.0 * (1 + 0.02 * np.sin(np.linspace(0, 40, ylen)))
    f0i[: ylen // 8] = 0.0
    vmask = (f0i > 75).astype(np.float64)
    forms = {i: np.full(t, 500.0 * i) for i in (1, 2, 3, 4)}
    cache: dict = {}
    plans = []
    for j in range(8):
        r = JaxResampler("dry.wav", "/dev/null", ("C4", "E4")[j % 2], 100,
                         ("t10B20", "t-20")[(j // 2) % 2], 0, 60, 20, 0, 100,
                         0, "!120", "AA", n_fft=n_fft, hop=hop,
                         autorender=False)
        plans.append(r.prepare(env, f0i, vmask, forms, sr, ylen,
                               cache=cache))
    assert len({p[0] for p in plans}) == 1
    return plans[0][0], [p[1] for p in plans], [p[2] for p in plans]


def _jax_sharded(rs, arrays, scalars, seed):
    stacked = [np.stack([np.asarray(a[k]) for a in arrays])
               for k in J_ARRAY_ORDER]
    sc = {k: np.stack([np.asarray(s.get(k, d), np.float32) for s in scalars])
          for k, d in j_default_scalars().items()}
    keys = np.stack([np.full(len(arrays), seed, np.uint32),
                     np.arange(len(arrays), dtype=np.uint32)], axis=1)
    return np.asarray(j_parallel.render_notes_sharded(
        j_parallel.make_mesh(8, tp=2), rs, tuple(0 for _ in J_ARRAY_ORDER),
        stacked, sc, keys))


def test_render_notes_sharded_matches_jax_mesh():
    """The port's sharded note render on 8 CPU slots against goofer_tpu's
    on its 8 virtual devices, on identical plans: noise zeroed, 5e-3 x
    peak outside pulse windows whose onset may land a sample off and 0.1
    dB; noise on (other RNGs), <= max(1 dB, goofer_tpu's seed-to-seed +
    0.5 dB)."""
    rs, arrays, scalars = _jax_small_group()
    rs_t = render_core.static_from_jax(rs)
    quiet = [dict(s, uv_strength=0.0, breath_strength=0.0) for s in scalars]
    want = _jax_sharded(rs, arrays, quiet, 0)
    got = render_notes_sharded(cpu_mesh(), rs_t, arrays, quiet,
                               [(0, j) for j in range(8)]).numpy()
    assert got.shape == want.shape == (8, rs.n)
    tensors, sc_t, _ = render_core.device_inputs(rs_t, arrays, quiet,
                                                 [0] * 8, "cpu")
    f0_t = render_core.assemble_f0_mask(
        rs_t, tensors["f0_cut"], tensors["mask_cut"], None,
        tensors["pitch_ticks"], sc_t)[1].numpy()
    for b in range(8):
        f0_j = _device_f0_mask(rs, arrays[b], quiet[b])[0]
        keep = _flip_exclusion_mask([f0_t[b].astype(np.float64)],
                                    [np.asarray(f0_j, np.float64)], f0_j, SR,
                                    rs.n)
        assert keep.mean() > 0.9
        peak = float(np.abs(want[b]).max())
        d = np.abs(got[b] - want[b])[keep] / peak
        assert d.max() <= 5e-3, (b, d.max())
        assert lsd_db(got[b], want[b], SR, 256, 64) < 0.1

    want = _jax_sharded(rs, arrays, scalars, 0)
    other = _jax_sharded(rs, arrays, scalars, 1)
    got = render_notes_sharded(cpu_mesh(), rs_t, arrays, scalars,
                               [(0, j) for j in range(8)]).numpy()
    for b in range(8):
        floor = lsd_db(other[b], want[b], SR, 256, 64)
        lsd = lsd_db(got[b], want[b], SR, 256, 64)
        assert lsd <= max(1.0, floor + 0.5), (b, lsd, floor)


TONES = [(0.31, 200, 1), (0.37, 170, 2), (0.31, 240, 3), (0.44, 210, 4),
         (0.37, 190, 5)]


def test_extract_features_batch_on_a_mesh():
    """Five files in two padded lengths on 8 slots (B = 3 and 2 per
    chunk: empty shards) and on 2: bit-equal to one device, and held to
    goofer_tpu's extraction sharded over its (4, 2) mesh."""
    ys = [_tone(d, f, seed=s) for d, f, s in TONES]
    one = features.extract_features_batch(ys, SR, dense=False, device="cpu")
    for m in (cpu_mesh(), cpu_mesh(2, tp=1)):
        got = features.extract_features_batch(ys, SR, dense=False, mesh=m)
        for row, ref in zip(got, one):
            assert row[0] is None
            for a, b in zip(row[1:3], ref[1:3]):
                assert np.array_equal(a, b)
            for k in ref[3]:
                assert np.array_equal(row[3][k], ref[3][k])
            assert np.array_equal(row[4]["knot_vals_log"],
                                  ref[4]["knot_vals_log"])
    theirs = j_features.extract_features_batch(
        ys, SR, dense=False, mesh=j_parallel.make_mesh(8, tp=2))
    for row, ref in zip(got, theirs):
        assert ref[0] is None
        assert _f16_equal_share(row[1], ref[1]) >= 0.999
        assert _f16_equal_share(row[2], ref[2]) >= 0.999
        assert _formant_share(row[3], ref[3]) >= 0.99
        assert _knots_within_a_step(row[4], ref[4])
    with pytest.raises(ValueError, match="device= or mesh="):
        features.extract_features_batch(ys[:1], SR, device="cpu",
                                        mesh=cpu_mesh())


def test_extract_features_recursive_on_a_mesh(tmp_path, monkeypatch):
    """The folder mode with a mesh writes the .goofy files the single-
    device run writes."""
    monkeypatch.delenv(config.DEVICE_ENV, raising=False)
    for name in ("one", "mesh"):
        (tmp_path / name).mkdir()
        for i, (d, f, s) in enumerate(TONES[:3]):
            write_wav(tmp_path / name / f"v{i}.wav", _tone(d, f, seed=s), SR)
    assert batch_extract.extract_features_recursive(
        tmp_path / "one", device="cpu") == 3
    assert batch_extract.extract_features_recursive(
        tmp_path / "mesh", mesh=cpu_mesh()) == 3
    for i in range(3):
        a = goofy.load_features(tmp_path / "one" / f"v{i}_features.goofy")
        b = goofy.load_features(tmp_path / "mesh" / f"v{i}_features.goofy")
        assert np.array_equal(a[0]["knot_vals_log"], b[0]["knot_vals_log"])
        for x, y in zip(a[1:3], b[1:3]):
            assert np.array_equal(x, y)
        assert all(np.array_equal(a[3][k], b[3][k]) for k in a[3])
        assert a[4:] == b[4:]


def test_dryrun_multichip_on_cpu_slots():
    dryrun.dryrun_multichip(8, devices=[CPU] * 8)
    dryrun.dryrun_multichip(3, devices=[CPU] * 3)
