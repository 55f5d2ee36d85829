"""The Hopper kernels against their plain versions, on the card.

Marked ``cuda``: these skip without a CUDA device.  Run them on the
machine with the card (``--noconftest``: tests/conftest.py imports JAX,
which that machine does not have):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Pulse tolerance 1e-4: both sides are float32 and the sum holds at most K
terms of size <= 1, so it leaves room only for CUDA vs ATen
transcendental rounding; the onsets themselves must agree, so every case
keeps its float64 phase more than 1e-9 from an integer (the kernel sums it
in another association order than torch.cumsum).  Cascade tolerance
1e-4 x max|x|: two float32 scans of the same recurrences in other
association orders.  The pitch Viterbi kernel must equal its plain
version exactly (both run the same float32 operations in the same order);
the root finder's matched roots agree to 1e-4 on rows that converged, and
the Burg coefficients to rtol 1e-3 / atol 1e-4 (another order of the
551-term sums).  The blur kernel agrees with its plain version (cuDNN's
conv1d of the reflect-padded rows, TF32 off) to 1e-5 x max|x|, and a row
equals itself launched alone, bit for bit."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from chip_smoke import (  # noqa: E402
    BLUR_TOL,
    BURG_ATOL,
    BURG_RTOL,
    CASCADE_TOL,
    PULSE_TOL,
    ROOTS_TOL,
    _f16_track_equal,
    _formants_close,
    _hold,
    _render_planned,
    blur_cases,
    cascade_cases,
    exact_phase_plain,
    facade_pulse_cases,
    f0_with_onsets,
    kernel_edges,
    knot_steps,
    known_root_polys,
    matched_root_error,
    pcm16,
    phase_margin,
    phrase_cascade_cases,
    phrase_notes,
    phrase_pulse_cases,
    pulse_pass_args,
    seeded_candidates,
    voicebank_cuts,
)
from goofer_tpu_torch.analysis import features, formants, pitch  # noqa: E402
from goofer_tpu_torch.ops import filters, jitter, pulse, scan_iir  # noqa: E402
from goofer_tpu_torch.ops import noise as rnd  # noqa: E402
from goofer_tpu_torch.ops.cuda import (  # noqa: E402
    blur_kernel,
    cascade_kernel,
    pulse_kernel,
)
from goofer_tpu_torch.ops.cuda.blur_kernel import gaussian_blur  # noqa: E402
from goofer_tpu_torch.ops.cuda.burg_kernel import burg_lpc  # noqa: E402
from goofer_tpu_torch.ops.cuda.lpc_roots_kernel import lpc_roots  # noqa: E402
from goofer_tpu_torch.ops.cuda.viterbi_kernel import pitch_viterbi  # noqa: E402
from goofer_tpu_torch.ops.cuda.cascade_kernel import one_pole_cascade  # noqa: E402
from goofer_tpu_torch.ops.cuda.pulse_kernel import pulse_accumulate  # noqa: E402
from goofer_tpu_torch.sampler import phrase, render_core  # noqa: E402
from goofer_tpu_torch.sampler.resampler import GooferResampler  # noqa: E402
from goofer_tpu_torch.utils.metrics import lsd_db  # noqa: E402
from tests.fixtures_common import (  # noqa: E402
    DET_CONFIGS,
    NOTE_ARGS,
    make_synth_features,
)

pytestmark = pytest.mark.cuda
SR = 44100


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _f0(n, batch):
    t = np.arange(n) / SR
    rng = np.random.default_rng(0)
    base = rng.uniform(90.0, 600.0, (batch, 1))
    f0 = base * 2 ** (0.3 * np.sin(2 * np.pi * 3.0 * t))[None]
    f0[:, : n // 8] = 0.0
    return f0.astype(np.float32)


def _hold_pulse_to_plain(f0, gate, args):
    """One kernel launch against the plain version, off phase ties."""
    assert phase_margin(f0, gate, args[0], args[1]) > 1e-9
    before = pulse_accumulate.launches
    got = pulse_accumulate(f0, gate, *args)
    want = pulse.pulse_pass_plain(f0, gate, *args)
    torch.cuda.synchronize()
    assert pulse_accumulate.launches == before + 1
    assert got.shape == f0.shape and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=PULSE_TOL, rtol=0.0)
    return got


@pytest.mark.parametrize("guard,rk,k", [(True, 0.8, 16), (False, 1.0, 8)])
@pytest.mark.parametrize("batch,n", [(1, 40000), (4, 9000)])
def test_kernel_matches_plain(dev, guard, rk, k, batch, n):
    """Main pass (guard) and gated pass (no guard, a voicing gate)."""
    f0_np = _f0(n, batch)
    f0 = torch.as_tensor(f0_np, device=dev)
    gate = None if guard else torch.as_tensor(
        (f0_np > 0).astype(np.float32), device=dev)
    scale = 1.0 if guard else 2.0
    got = _hold_pulse_to_plain(f0, gate, (SR, scale, 160.0 * scale, 0.02,
                                          1.7, rk, guard, k, 16))
    assert float(got.abs().max()) > 0.5


def _grid_case(gated, batch, n):
    """Gliding f0 over 90-600 Hz per row, unvoiced at the start and in
    the middle; the gated pass adds voicing-gate gaps."""
    rng = np.random.default_rng(n * 10 + batch + gated)
    t = np.arange(n) / SR
    base = rng.uniform(90.0, 600.0, (batch, 1))
    f0 = base * 2 ** (0.3 * np.sin(2 * np.pi * rng.uniform(1, 6, (batch, 1))
                                   * t[None]))
    f0[:, : n // 8] = 0.0
    f0[:, n // 2: n // 2 + n // 5] = 0.0
    gate = None
    if gated:
        gate = np.ones((batch, n), np.float32)
        gate[:, n // 3: n // 3 + n // 10] = 0.0
    return f0.astype(np.float32), gate


@pytest.mark.parametrize("spacing", [8, 64, 256])
@pytest.mark.parametrize("k", [3, 8, 16, 32])
@pytest.mark.parametrize("n", [1, 2, 5, 1025, 48510, 65537, 262144])
@pytest.mark.parametrize("batch", [1, 4, 8])
@pytest.mark.parametrize("gated", [False, True], ids=["main", "gated"])
def test_pulse_kernel_grid(dev, gated, batch, n, k, spacing):
    """Rows of 1 to four tiles, B = 1, 4 and 8, K 3-32, spacings 8-256
    (at 256, pitches above 172 Hz overflow the M table rows)."""
    f0_np, gate_np = _grid_case(gated, batch, n)
    args = pulse_pass_args(f0_np, gated)[:-2] + (k, spacing)
    _hold_pulse_to_plain(
        torch.as_tensor(f0_np, device=dev),
        None if gate_np is None else torch.as_tensor(gate_np, device=dev),
        args)


@pytest.mark.parametrize("spacing", [16, 256])
@pytest.mark.parametrize("gated", [False, True], ids=["main", "gated"])
def test_pulse_kernel_edges_and_overflow(dev, gated, spacing):
    """Onsets at the kernel's run, warp, CTA and tile edges, one sample
    apart there and ~173 samples apart elsewhere: at spacing 256 rows past
    M occur from the second tile on.  A silent row gives exact zeros."""
    n = 2 * pulse_kernel.TILE + 777
    edges = kernel_edges(n)
    f0 = np.stack([f0_with_onsets(edges, n), np.zeros(n, np.float32)])
    gate = np.ones_like(f0) if gated else None
    args = (SR, 1.0, 160.0, 0.02, 1.7, 1.0 if gated else 0.8, not gated, 16,
            spacing)
    got = _hold_pulse_to_plain(
        torch.as_tensor(f0, device=dev),
        None if gate is None else torch.as_tensor(gate, device=dev), args)
    assert float(got[1].abs().max()) == 0.0
    assert (len(edges) > pulse_kernel.table_rows(n, spacing)) == (
        spacing == 256)


@pytest.mark.parametrize("gated", [False, True], ids=["main", "gated"])
def test_pulse_kernel_unstaged_window(dev, gated):
    """Onsets every 2-3 samples (16-20 kHz): the rows a CTA's samples
    reach outgrow the WINDOW rows of its shared stage, so the
    accumulation reads them from L2."""
    n = 48510
    rng = np.random.default_rng(5)
    f0_np = rng.uniform(16000.0, 20000.0, (2, n)).astype(np.float32)
    f0 = torch.as_tensor(f0_np, device=dev)
    gate = torch.ones_like(f0) if gated else None
    args = (SR, 1.0, 160.0, 0.02, 1.7, 1.0 if gated else 0.8, not gated, 16,
            8)
    _, seg = pulse_kernel.tile_geometry(n)
    row = pulse.pulse_pass_tables(f0, gate, *args[:-2], 8)[0]
    assert int(row[0, seg - 1]) + 1 + 16 > pulse_kernel.WINDOW
    _hold_pulse_to_plain(f0, gate, args)


def test_pulse_kernel_phase_ties(dev):
    """Constant 220, 441 and 110.25 Hz at 44.1 kHz (the voice goldens'
    pitches): the phase comes within 1e-13 of an integer every 11, 1 and
    4 periods.  The kernel fires each crossing once, where the exact sum
    of its float64 steps crosses."""
    f0 = torch.stack([torch.full((48510,), hz, device=dev)
                      for hz in (220.0, 441.0, 110.25)])
    args = (SR, 1.0, 160.0, 0.02, 1.7, 0.8, True, 8, 128)
    got = pulse_accumulate(f0, None, *args)
    want = exact_phase_plain(f0, args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=PULSE_TOL, rtol=0.0)


def test_pulse_kernel_nonfinite_steps(dev):
    """An inf step fires one onset and ends the row's onsets, a NaN step
    ends them, as in the plain version's float64 phase."""
    f0_np, _ = _grid_case(False, 2, 9000)
    f0_np[0, 3000] = np.inf
    f0_np[1, 5000] = np.nan
    f0 = torch.as_tensor(f0_np, device=dev)
    args = (SR, 1.0, 160.0, 0.02, 1.7, 0.8, True, 16, 16)
    got = pulse_accumulate(f0, None, *args)
    want = pulse.pulse_pass_plain(f0, None, *args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=PULSE_TOL, rtol=0.0)


def test_pulse_kernel_silence(dev):
    for n in (1, 1025, 262144):
        f0 = torch.zeros((2, n), device=dev)
        for gate in (None, torch.ones_like(f0)):
            got = pulse_accumulate(f0, gate, SR, 1.0, 160.0, 0.02, 1.7, 0.8,
                                   gate is None, 16, 16)
            torch.cuda.synchronize()
            assert float(got.abs().max()) == 0.0


def test_pulse_launches_once_per_pass(dev):
    """One launch per pulse_train pass and per subharmonic semitone; none
    on the CPU."""
    f0 = torch.as_tensor(_f0(9000, 1)[0], device=dev)
    before = pulse_accumulate.launches
    pulse.pulse_train(f0, SR)
    assert pulse_accumulate.launches == before + 1
    pulse.subharm_pulse_train(f0, SR, (f0 > 0).float(), [12.0, -12.0], 0.5)
    assert pulse_accumulate.launches == before + 3
    pulse.pulse_train(f0.cpu(), SR)
    assert pulse_accumulate.launches == before + 3


def test_pulse_train_on_card_matches_cpu(dev):
    f0 = _f0(20000, 1)[0]
    got = pulse.pulse_train(torch.as_tensor(f0, device=dev), SR).cpu()
    want = pulse.pulse_train(torch.as_tensor(f0), SR)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0.0)


def test_wrapper_rejects_bad_inputs(dev):
    f0 = torch.full((2, 64), 220.0, device=dev)
    args = (SR, 1.0, 160.0, 0.02, 1.7, 0.8, True, 8, 16)
    with pytest.raises(ValueError, match="float32"):
        pulse_accumulate(f0.double(), None, *args)
    with pytest.raises(ValueError, match="contiguous"):
        pulse_accumulate(f0.t().contiguous().t(), None, *args)
    with pytest.raises(ValueError, match=r"\(B, n\)"):
        pulse_accumulate(f0[0], None, *args)
    with pytest.raises(ValueError, match=r"\(B, n\)"):
        pulse_accumulate(f0, torch.ones((2, 63), device=dev), *args)
    with pytest.raises(ValueError, match="gate"):
        pulse_accumulate(f0, torch.ones((2, 64), device=dev).half(), *args)


@pytest.mark.parametrize("case", cascade_cases(), ids=lambda c: c[0])
def test_cascade_kernel_matches_plain(dev, case):
    """chip_smoke.py's cases: the note render's shapes and coefficients."""
    name, x_np, alpha_np, order, btype = case
    x = torch.as_tensor(x_np, device=dev)
    alpha = torch.as_tensor(alpha_np, device=dev)
    before = one_pole_cascade.launches
    got = one_pole_cascade(x, alpha, order, btype)
    want = scan_iir.one_pole_cascade_plain(x, alpha, order, btype)
    torch.cuda.synchronize()
    assert one_pole_cascade.launches == before + 1
    assert got.shape == x.shape and torch.isfinite(got).all()
    if name == "silence":
        assert float(got.abs().max()) == 0.0
    else:
        tol = CASCADE_TOL * float(x.abs().max())
        torch.testing.assert_close(got, want, atol=tol, rtol=0.0)


def _hold_to_plain(x, alpha, order, btype):
    before = one_pole_cascade.launches
    got = one_pole_cascade(x, alpha, order, btype)
    want = scan_iir.one_pole_cascade_plain(x, alpha, order, btype)
    torch.cuda.synchronize()
    assert one_pole_cascade.launches == before + 1
    assert got.shape == x.shape and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0.0,
                               atol=CASCADE_TOL * float(x.abs().max()))


@pytest.mark.parametrize("order,btype", [(o, b) for b in ("lowpass",
                                                          "highpass")
                                         for o in (1, 2, 6, 12)])
@pytest.mark.parametrize("batch,per_row", [(1, False), (1, True), (2, False),
                                           (2, True), (8, False), (8, True)])
@pytest.mark.parametrize("n", [1, 2, 5, 1025, 48510, 262144])
def test_cascade_kernel_edges(dev, n, batch, per_row, order, btype):
    """Row lengths from one sample to four tiles, (n,) and (B, n)
    coefficients, against the plain version."""
    rng = np.random.default_rng(n * 100 + batch * 10 + order)
    x = rng.standard_normal((batch, n)).astype(np.float32)
    x[:, n // 3:] += 2.0
    alpha = rng.uniform(0.9, 0.999, (batch, n) if per_row else n)
    _hold_to_plain(torch.as_tensor(x, device=dev),
                   torch.as_tensor(alpha.astype(np.float32), device=dev),
                   order, btype)


@pytest.mark.parametrize("order,btype", [(1, "highpass"), (12, "highpass"),
                                         (6, "lowpass")])
def test_cascade_kernel_steps_at_boundaries(dev, order, btype):
    """Steps at a run, a warp, a CTA and a tile boundary of the kernel's
    decomposition: a wrong carry or HP boundary value shows there."""
    run = cascade_kernel.RUN
    n = 2 * cascade_kernel.TILE + 777
    x = np.zeros((2, n), np.float32)
    for edge in (37 * run, 3 * 32 * run, cascade_kernel.THREADS * run,
                 cascade_kernel.TILE, 2 * cascade_kernel.TILE):
        x[0, edge:] += 1.0
        x[1, edge - 1:] -= 0.5
    alpha = np.linspace(0.95, 0.999, n, dtype=np.float32)
    _hold_to_plain(torch.as_tensor(x, device=dev),
                   torch.as_tensor(alpha, device=dev), order, btype)


def test_cascade_kernel_silent_rows(dev):
    """Silent rows of every length class give exact zeros."""
    for n in (1, 1025, 262144):
        x = torch.zeros((2, n), device=dev)
        alpha = torch.full((n,), 0.98, device=dev)
        for btype in ("lowpass", "highpass"):
            got = one_pole_cascade(x, alpha, 12, btype)
            torch.cuda.synchronize()
            assert float(got.abs().max()) == 0.0


def test_cascade_wrapper_rejects_bad_inputs(dev):
    x = torch.ones((2, 64), device=dev)
    alpha = torch.full((64,), 0.9, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        one_pole_cascade(x.t().contiguous().t(), alpha, 2, "highpass")
    with pytest.raises(ValueError, match="float32"):
        one_pole_cascade(x.double(), alpha, 2, "highpass")
    with pytest.raises(ValueError, match="alpha"):
        one_pole_cascade(x, alpha.double(), 2, "lowpass")
    with pytest.raises(ValueError, match=r"\(B, n\)"):
        one_pole_cascade(x, alpha[:10], 2, "lowpass")
    with pytest.raises(ValueError, match="order"):
        one_pole_cascade(x, alpha, cascade_kernel.MAX_ORDER + 1, "lowpass")


@pytest.mark.parametrize("cfg_id", ["env-fx", "loops-concat", "subharm",
                                    "fry-pd-st", "layers"])
def test_render_on_card_matches_cpu(dev, cfg_id):
    """The whole deterministic note chain (noise stems zeroed, P0) on the
    card against the same port on the CPU: cuFFT, cuDNN and CUDA math
    against pocketfft, oneDNN and the CPU kernels.  The parity suite's
    budgets: <= 0.1 dB LSD, and 5e-3 x peak on all but 0.1% of samples
    (a pulse onset whose phase sits within rounding of an integer may
    land one sample off)."""
    _, pitch, vel, flags, ps, length_ms, _, _ = next(
        c for c in DET_CONFIGS if c[0] == cfg_id)
    r = GooferResampler(
        "/nonexistent.wav", "/dev/null", pitch, vel, flags,
        NOTE_ARGS["offset"], length_ms, NOTE_ARGS["consonant"],
        NOTE_ARGS["cutoff"], NOTE_ARGS["volume"], NOTE_ARGS["modulation"],
        NOTE_ARGS["tempo"], ps, device="cpu", autorender=False)
    rs, arrays, sc = r.prepare(*make_synth_features())
    sc = dict(sc, uv_strength=0.0, breath_strength=0.0)
    before = pulse_accumulate.launches, one_pole_cascade.launches
    gpu = render_core.render_note(rs, arrays, sc, 0, dev).cpu().numpy()
    assert pulse_accumulate.launches > before[0]
    # fry-pd-st: fry blend + st; layers: su + st
    uses_cascade = cfg_id in ("fry-pd-st", "layers")
    assert (one_pole_cascade.launches > before[1]) == uses_cascade
    cpu = render_core.render_note(rs, arrays, sc, 0, "cpu").numpy()
    assert gpu.shape == cpu.shape and np.isfinite(gpu).all()
    d = np.abs(gpu - cpu) / (np.abs(cpu).max() + 1e-12)
    assert float((d > 5e-3).mean()) <= 1e-3, float(d.max())
    assert lsd_db(gpu, cpu, SR) < 0.1


@pytest.mark.parametrize("name", ["phrase_b50", "phrase_b80",
                                  "phrase_sg_b80", "phrase_b13_shard",
                                  "phrase_b20_shard", "phrase_sg_b20_shard"])
def test_pulse_kernel_phrase_shapes(dev, name):
    """A phrase group's rows in one launch: B = 50 and 80 rows spanning
    G3-C5 at the K = 32 a heavy group is harmonized to, and the gated sg
    pass; the onset scratch grows with B.  13 and 20 rows: a shard of
    each group on a four-slot mesh."""
    _, f0_np, gate_np, k = next(c for c in phrase_pulse_cases()
                                if c[0] == name)
    f0 = torch.as_tensor(f0_np, device=dev)
    gate = None if gate_np is None else torch.as_tensor(gate_np, device=dev)
    _hold_pulse_to_plain(f0, gate, pulse_pass_args(f0_np, gate is not None,
                                                   k))


@pytest.mark.parametrize("name", ["phrase_hp12_b80", "phrase_lp4_b80",
                                  "phrase_hp6_fry_b160", "phrase_hp12_b20",
                                  "phrase_lp4_b20", "phrase_hp6_fry_b40"])
def test_cascade_kernel_phrase_shapes(dev, name):
    """A phrase group's rows in one launch, each with its own (B, n)
    coefficient row, and the fry pair's 160 rows sharing one; and a shard
    of the group on a four-slot mesh (20 rows, the pair's 40)."""
    _, x_np, alpha_np, order, btype = next(
        c for c in phrase_cascade_cases() + phrase_cascade_cases(20)
        if c[0] == name)
    x = torch.as_tensor(x_np, device=dev)
    alpha = torch.as_tensor(alpha_np, device=dev)
    before = one_pole_cascade.launches
    got = one_pole_cascade(x, alpha, order, btype)
    want = scan_iir.one_pole_cascade_plain(x, alpha, order, btype)
    torch.cuda.synchronize()
    assert one_pole_cascade.launches == before + 1
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= CASCADE_TOL * float(
        x.abs().max())


def test_phrase_row_equals_note_alone_on_card(dev, tmp_path):
    """On the card a phrase's row is the note rendered alone with the same
    (seed, index) key, the heavy stack's noise included (the draws are
    keyed per note), and a group launches each kernel once per pass."""
    import shutil
    from pathlib import Path

    voice = Path(__file__).parent / "golden" / "voice"
    shutil.copy(voice / "src.wav", tmp_path / "a.wav")
    shutil.copy(voice / "src_features.goofy", tmp_path / "a_features.goofy")
    heavy = "sh30sr30sg40su40sj20st-30vf40es30pd40fw20fsta50"
    notes = [phrase.NoteSpec(str(tmp_path / "a.wav"), p, length=400,
                             consonant=60, flags=f)
             for p, f in (("C4", "t10"), ("G3", heavy), ("E4", "B20"),
                          ("C5", heavy + "t-20"), ("A3", heavy))]
    before = pulse_accumulate.launches, one_pole_cascade.launches
    outs = phrase.render_phrase(notes, seed=5, device=dev)
    assert pulse_accumulate.launches - before[0] == 1 + 4
    assert one_pole_cascade.launches - before[1] == 5
    planned, _ = phrase.plan_phrase(notes, device=dev)
    for pl, out in zip(planned, outs):
        alone = render_core.render_note(pl.rs, pl.arrays, pl.scalars,
                                        (5, pl.index), dev).cpu().numpy()
        assert out.shape == alone.shape and np.isfinite(out).all()
        d = np.abs(out - alone) / (np.abs(alone).max() + 1e-12)
        assert float((d > 5e-3).mean()) <= 1e-3, float(d.max())
        assert lsd_db(out, alone, SR) < 0.1


# ------------------------------------------------------- analysis kernels

@pytest.mark.parametrize("frames", [1, 2, 33, 338, 2049, 10300])
@pytest.mark.parametrize("batch", [1, 2, 16, 64])
def test_viterbi_kernel_equals_plain(dev, batch, frames):
    """Ragged frame counts (row 0 full, row 1 a single frame); 10300
    frames overflow the kernel's shared backpointers into its global
    scratch."""
    args = [torch.as_tensor(a, device=dev) for a in
            seeded_candidates(batch, frames, 100 * batch + frames)]
    costs = pitch.transition_costs(pitch.PitchConfig(), 256 / SR)
    before = pitch_viterbi.launches
    f0, path = pitch_viterbi(*args, *costs)
    want_f0, want_path = pitch.viterbi_plain(*args, *costs)
    torch.cuda.synchronize()
    assert pitch_viterbi.launches == before + 1
    assert torch.equal(path.long(), want_path)
    assert torch.equal(f0, want_f0)
    nf = args[3].long()
    past = torch.arange(frames, device=dev)[None] >= nf[:, None]
    assert (f0[past] == 0).all() and (path[past] == -1).all()


@pytest.mark.parametrize("k", [1, 4, 12, 31])
def test_viterbi_wrapper_rejects_other_state_counts(dev, k):
    """The kernel is unrolled for the tracker's 6 candidates: any other
    count raises on the card and launches nothing."""
    args = [torch.zeros((2, 5, k), device=dev),
            torch.zeros((2, 5, k), device=dev),
            torch.zeros((2, 5), device=dev),
            torch.full((2,), 5, dtype=torch.int32, device=dev)]
    before = pitch_viterbi.launches
    with pytest.raises(ValueError, match="candidates"):
        pitch_viterbi(*args, 0.1, 0.2)
    assert pitch_viterbi.launches == before


def _roots_row_counts():
    """(order, rows): 1 row, a warp's rows +- 1, a CTA's rows +- 1 (the
    kernel packs floor(32 / order) rows per warp, 4 warps per CTA) and
    5000, at orders on each side of a packing change."""
    cases = []
    for order in (1, 3, 8, 10, 11, 16, 17, 32):
        per_warp = 32 // order
        counts = {1, per_warp - 1, per_warp + 1, 4 * per_warp - 1,
                  4 * per_warp + 1, 5000}
        cases += [(order, n) for n in sorted(counts) if n >= 1]
    return cases


@pytest.mark.parametrize("order,rows", _roots_row_counts())
def test_lpc_roots_kernel_matches_plain(dev, order, rows):
    coeffs, known = known_root_polys(rows, rows, order)
    a = torch.as_tensor(coeffs, device=dev)
    before = lpc_roots.launches
    got = lpc_roots(a)
    want = formants.poly_roots_dk_plain(a)
    torch.cuda.synchronize()
    assert lpc_roots.launches == before + 1
    assert got.shape == (rows, order) and got.dtype == torch.complex64
    conv = formants.converged_roots(a, want).all(dim=1)
    assert conv.float().mean() > 0.99
    assert float(matched_root_error(got[conv], want[conv]).max()) <= ROOTS_TOL
    truth = torch.as_tensor(known, device=dev).to(torch.complex64)
    assert float(matched_root_error(got[conv], truth[conv]).max()) <= 1e-3


def test_lpc_roots_kernel_zero_frame(dev):
    """An all-zero frame's polynomial z^10: no NaN that the plain version
    does not have."""
    a = torch.zeros((3, 11), device=dev)
    a[:, 0] = 1.0
    a[1, 1:] = torch.as_tensor(known_root_polys(1, 0)[0][0, 1:], device=dev)
    got = torch.view_as_real(lpc_roots(a))
    want = torch.view_as_real(formants.poly_roots_dk_plain(a))
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.testing.assert_close(got, want, atol=ROOTS_TOL, rtol=0.0)


@pytest.mark.parametrize("order", [3, 10, 16, 32])
def test_lpc_roots_kernel_rows_equal_alone(dev, order):
    """Zero polynomials (z^order) and a NaN row packed between ordinary
    rows over three warps' worth: every row equals itself launched
    alone, bit for bit."""
    rows = 3 * (32 // order) + 1
    a = torch.as_tensor(known_root_polys(rows, order, order)[0], device=dev)
    a[1::3, 1:] = 0.0
    a[rows // 2, 2] = float("nan")
    together = torch.view_as_real(lpc_roots(a))
    for i in range(rows):
        alone = torch.view_as_real(lpc_roots(a[i:i + 1].contiguous()))
        torch.testing.assert_close(together[i:i + 1], alone, rtol=0.0,
                                   atol=0.0, equal_nan=True)


def _burg_frames(rows, wlen, seed):
    """Noise frames with a resonance, Gaussian-windowed; one silent."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, wlen + 2))
    x = x[:, 2:] + 1.6 * x[:, 1:-1] - 0.9 * x[:, :-2]
    t = np.linspace(-1, 1, wlen)
    frames = (x * np.exp(-12 * t * t)).astype(np.float32)
    frames[rows // 2] = 0.0 if rows > 2 else frames[rows // 2]
    return frames


# wlen 1152 is the last frame held in registers (36 samples a lane), 1153
# the first in shared memory; 4 frames per CTA there, 1 at 4010
@pytest.mark.parametrize("rows,wlen,order", [
    (1, 551, 10), (33, 551, 10), (5000, 551, 10), (7, 600, 12),
    (5, 32, 10), (3, 4010, 8), (6, 32, 32), (9, 1152, 10), (9, 1153, 10),
    (5, 4010, 32), (7, 5, 10), (3, 1, 2), (1, 1, 32), (5, 100, 32),
    (2, 2049, 12)])
def test_burg_kernel_matches_plain(dev, rows, wlen, order):
    frames = torch.as_tensor(_burg_frames(rows, wlen, rows + wlen),
                             device=dev)
    before = burg_lpc.launches
    got = burg_lpc(frames, order)
    want = formants.burg_coeffs_plain(frames, order)
    torch.cuda.synchronize()
    assert burg_lpc.launches == before + 1
    assert got.shape == (rows, order + 1) and (got[:, 0] == 1).all()
    torch.testing.assert_close(got, want, rtol=BURG_RTOL, atol=BURG_ATOL)


@pytest.mark.parametrize("wlen", [32, 551, 1152, 1153, 4010])
def test_burg_kernel_rows_equal_alone(dev, wlen):
    """Six frames, so the last CTA is not full: each frame's coefficients
    equal its own launch's, bit for bit."""
    frames = torch.as_tensor(_burg_frames(6, wlen, wlen), device=dev)
    together = burg_lpc(frames, 10)
    for i in range(6):
        assert torch.equal(together[i:i + 1],
                           burg_lpc(frames[i:i + 1].contiguous(), 10))


def _hold_blur(x, sigma, axis):
    taps = filters.gaussian_kernel1d(sigma)
    before = gaussian_blur.launches
    got = gaussian_blur(x, taps, axis)
    want = filters.blur_plain(x, taps, axis)
    torch.cuda.synchronize()
    assert gaussian_blur.launches == before + 1
    assert got.shape == x.shape and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0.0,
                               atol=BLUR_TOL * float(x.abs().max()))
    return got, taps


@pytest.mark.parametrize("case", blur_cases(), ids=lambda c: c[0])
def test_blur_kernel_matches_plain(dev, case):
    """chip_smoke.py's cases: the heavy note's and phrase (b)'s blurs."""
    _, x_np, sigma, axis = case
    _hold_blur(torch.as_tensor(x_np, device=dev), sigma, axis)


@pytest.mark.parametrize("sigma", [0.5, 2.0, 25.0, 441.0, 882.0])
@pytest.mark.parametrize("n", [1, 2, 5, blur_kernel.TILE - 1,
                               blur_kernel.TILE, blur_kernel.TILE + 1,
                               2 * blur_kernel.TILE + 3, 48510])
@pytest.mark.parametrize("batch", [1, 3])
def test_blur_kernel_rows_at_tile_edges(dev, batch, n, sigma):
    """Rows from one sample to past two tiles, windows longer than the
    row (repeated reflection), up to the 7057 taps of the roughness
    noise's sigma 882."""
    rng = np.random.default_rng(n + batch)
    x = torch.as_tensor(rng.standard_normal((batch, n)).astype(np.float32),
                        device=dev)
    _hold_blur(x, sigma, -1)


@pytest.mark.parametrize("shape,axis", [((4, 513, 130), -2),
                                        ((2, 17, 1), 1), ((513, 9), 0),
                                        ((3, 5, 129), 1), ((2, 3, 7, 11), 1)])
@pytest.mark.parametrize("sigma", [0.5, 1.75, 7.0])
def test_blur_kernel_inner_axes(dev, shape, axis, sigma):
    rng = np.random.default_rng(len(shape) * 10 + shape[0])
    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                        device=dev)
    _hold_blur(x, sigma, axis)


@pytest.mark.parametrize("shape,axis,sigma", [
    ((80, 33074), -1, 441.0), ((80, 8270), -1, 12.25),
    ((80, 513, 130), -2, 0.5), ((80, 513, 344), -2, 2.0)])
def test_blur_kernel_rows_equal_alone(dev, shape, axis, sigma):
    """Every row of a batch of 80 equals the same row launched alone, bit
    for bit: no tile, block or batch size enters a row's sum."""
    x = torch.as_tensor(np.random.default_rng(80).standard_normal(
        shape).astype(np.float32), device=dev)
    together, taps = _hold_blur(x, sigma, axis)
    for i in range(shape[0]):
        assert torch.equal(together[i], gaussian_blur(x[i:i + 1], taps,
                                                      axis)[0])


def test_blur_wrapper_rejects_bad_inputs(dev):
    taps = filters.gaussian_kernel1d(2.0)
    with pytest.raises(ValueError, match="float32"):
        gaussian_blur(torch.zeros((2, 64), device=dev).double(), taps)
    with pytest.raises(ValueError, match="odd"):
        gaussian_blur(torch.zeros((2, 64), device=dev), taps[:-1])
    with pytest.raises(ValueError, match="odd"):
        gaussian_blur(torch.zeros((2, 64), device=dev),
                      filters.gaussian_kernel1d(2100.0))


def test_istft_row_equals_alone_with_imaginary_edges(dev):
    """Random-phase spectra whose DC and Nyquist bins carry imaginary
    parts, as the noise stems' do: a row of a batch of 80 through istft
    equals the row alone to float rounding (cuFFT's C2R, reading those
    parts, gives another result at another batch size)."""
    from goofer_tpu_torch.ops import stft

    rng = np.random.default_rng(3)
    S = torch.complex(*(torch.as_tensor(rng.standard_normal(
        (80, 513, 130)).astype(np.float32), device=dev) for _ in range(2)))
    together = stft.istft(S, 256, 33074)
    for i in (0, 40, 79):
        alone = stft.istft(S[i:i + 1], 256, 33074)
        torch.testing.assert_close(together[i:i + 1], alone, rtol=0.0,
                                   atol=1e-5 * float(alone.abs().max()))


def test_noisy_phrase_row_equals_note_alone_on_card(dev, tmp_path):
    """Phrase (b)'s heavy notes with the noise on: a row of the batch of
    80 against the same note alone, held to the noise-zeroed budget."""
    import shutil
    from pathlib import Path

    voice = Path(__file__).parent / "golden" / "voice"
    for ext in (".wav", "_features.goofy"):
        shutil.copy(voice / f"src{ext}", tmp_path / f"voice{ext}")
    notes = phrase_notes(str(tmp_path / "voice.wav"))["b"]
    planned, outs = _render_planned(notes, "auto", False)
    for i in (0, 41, 79):
        pl = planned[i]
        alone = render_core.render_note(pl.rs, pl.arrays, pl.scalars, (0, i),
                                        dev).cpu().numpy()
        _hold(f"phrase b note {i}", outs[i], alone, True)


def test_burg_wrapper_rejects_long_frames(dev):
    with pytest.raises(ValueError, match="wlen"):
        burg_lpc(torch.zeros((2, 4011), device=dev), 10)


def test_batch_of_64_files_equals_each_alone(dev):
    """The 64-file bank as one extract_features_batch call against every
    file alone: f0 and mask at float16, the same K, knots to one float16
    step, formants within 1 Hz on >= 99% of entries."""
    cuts = [pcm16(y) for y in voicebank_cuts()]
    before = pitch_viterbi.launches
    batch = features.extract_features_batch(cuts, SR, dense=False, device=dev)
    chunks = pitch_viterbi.launches - before
    assert 1 <= chunks < 16
    for i, (y, row) in enumerate(zip(cuts, batch)):
        alone = features.extract_features(y, SR, dense=False, device=dev)
        assert row[0] is None and alone[0] is None
        _f16_track_equal(f"file {i} f0", row[1], alone[1])
        _f16_track_equal(f"file {i} mask", row[2], alone[2])
        k_b, k_a = row[4]["knot_vals_log"], alone[4]["knot_vals_log"]
        assert k_b.shape == k_a.shape, i
        assert knot_steps(k_a, k_b) <= 1.001, i
        _formants_close(f"file {i}", row[3], alone[3])


@pytest.mark.parametrize("name", ["facade_main", "facade_sub_p12"])
def test_pulse_kernel_facade_densest(dev, name):
    """The facade's densest pulse passes (f0 x 2 under the default f0
    jitter, and the +12 semitone on its vibrato track) with the table
    bounds models/hnm.pulse_bounds derives, off phase ties."""
    _, f0_np, gate_np, k, spacing = next(c for c in facade_pulse_cases()
                                         if c[0] == name)
    f0 = torch.as_tensor(f0_np, device=dev)
    gate = None if gate_np is None else torch.as_tensor(gate_np, device=dev)
    _hold_pulse_to_plain(f0, gate, pulse_pass_args(
        f0_np, gate is not None, k, spacing))


@pytest.mark.parametrize("n", [44100, 262144])
def test_one_pole_highpass_on_card(dev, n):
    """vocal_roughness's static high-pass through the cascade kernel (one
    launch) against the CPU's plain scan, 1e-4 x max|x|."""
    x = torch.as_tensor(np.random.default_rng(n).standard_normal(
        (2, n)).astype(np.float32))
    before = one_pole_cascade.launches
    got = scan_iir.one_pole_highpass(x.to(dev), SR, 320.0)
    torch.cuda.synchronize()
    assert one_pole_cascade.launches == before + 1
    want = scan_iir.one_pole_highpass(x, SR, 320.0)
    torch.testing.assert_close(got.cpu(), want, rtol=0.0,
                               atol=CASCADE_TOL * float(x.abs().max()))


def test_vocal_roughness_card_vs_cpu(dev):
    """The same keys draw the same noise on both devices: the card's
    roughness equals the CPU's to 1e-3 x peak (blur and phase rounding)."""
    n = 44100
    t = np.arange(n) / SR
    f0 = (180.0 * 2 ** (0.3 * np.sin(2 * np.pi * 3.1 * t))).astype(
        np.float32)
    f0[n // 3: n // 2] = 0.0
    y = pulse.pulse_train(torch.as_tensor(f0)[None], SR)
    y = torch.cat([y, 0.5 * y])
    mask = (torch.as_tensor(f0) > 0).float()
    keys = torch.as_tensor(rnd.stream_keys([0, 1], 1)[:, 0])
    want = jitter.vocal_roughness(keys, y, torch.as_tensor(f0), mask, SR)
    got = jitter.vocal_roughness(keys.to(dev), y.to(dev),
                                 torch.as_tensor(f0, device=dev),
                                 mask.to(dev), SR).cpu()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0.0,
                               atol=1e-3 * float(want.abs().max()))


# ------------------------------------------------------------ mesh path

def _card_mesh(n, tp=1):
    from goofer_tpu_torch.parallel import make_mesh

    return make_mesh(n, tp=tp, devices=[torch.device("cuda", 0)] * n)


@pytest.mark.parametrize("k", [63, 64])
def test_tp_log_env_bit_equal_on_card(dev, k):
    """dp 2 x tp 2 on four slots of the card: the tp-reduced log-envelope
    is decode_log_env_from_knots bit for bit."""
    from goofer_tpu_torch.ops.envelope import decode_log_env_from_knots
    from goofer_tpu_torch.parallel.batch import tp_log_env

    knots = torch.as_tensor(np.random.default_rng(k).normal(
        -4.0, 3.0, (4, k, 200)).astype(np.float32), device=dev)
    rows = tp_log_env(_card_mesh(4, tp=2), knots, SR, 1024, 513)
    want = decode_log_env_from_knots(knots, SR, 1024, 513)
    assert [r.shape[0] for r in rows] == [2, 2]
    assert torch.equal(torch.cat(rows), want)


def test_phrase_on_a_card_mesh(dev, tmp_path):
    """Three notes of one group on two slots of the card: one launch per
    pass per shard.  Each note keeps its noise key on either slot, so with
    the noise on a row is held to the single-device render by the
    noise-zeroed budget: 5e-3 x peak on all but 0.1% of samples and
    0.1 dB LSD."""
    import shutil
    from pathlib import Path

    voice = Path(__file__).parent / "golden" / "voice"
    shutil.copy(voice / "src.wav", tmp_path / "a.wav")
    shutil.copy(voice / "src_features.goofy", tmp_path / "a_features.goofy")
    notes = [phrase.NoteSpec(str(tmp_path / "a.wav"), p, length=400,
                             consonant=60, flags=f)
             for p, f in (("C4", "t10"), ("E4", "B20"), ("G3", "t-20"))]
    one = phrase.render_phrase(notes, seed=5, device=dev)
    before = pulse_accumulate.launches
    got = phrase.render_phrase(notes, seed=5, mesh=_card_mesh(2))
    assert pulse_accumulate.launches - before == 2
    for a, b in zip(got, one):
        assert a.shape == b.shape and np.isfinite(a).all()
        assert (np.abs(a - b) > 5e-3 * np.abs(b).max()).mean() <= 1e-3
        assert lsd_db(a, b, SR) < 0.1


def test_extraction_on_a_card_mesh(dev):
    """Five bank files on three slots: one launch of each analysis kernel
    per non-empty shard, rows within the folder-row budget of one device."""
    cuts = [pcm16(y) for y in voicebank_cuts()[:5]]
    plan = list(features.chunk_plan([len(y) for y in cuts], 256, 64, 16384))
    one = features.extract_features_batch(cuts, SR, dense=False, device=dev)
    before = pitch_viterbi.launches, lpc_roots.launches, burg_lpc.launches
    got = features.extract_features_batch(cuts, SR, dense=False,
                                          mesh=_card_mesh(3))
    want = sum(min(len(part), 3) for _, part in plan)
    assert (pitch_viterbi.launches - before[0], lpc_roots.launches
            - before[1], burg_lpc.launches - before[2]) == (want,) * 3
    for i, (row, ref) in enumerate(zip(got, one)):
        _f16_track_equal(f"file {i} f0", row[1], ref[1])
        _f16_track_equal(f"file {i} mask", row[2], ref[2])
        assert knot_steps(row[4]["knot_vals_log"],
                          ref[4]["knot_vals_log"]) <= 1.001
        _formants_close(f"file {i}", row[3], ref[3])
