"""The port's pulse train vs goofer_tpu's on the CPU.

On the CPU the kernel wrapper runs the plain PyTorch pulse pass
(ops/pulse.py:pulse_pass_plain, built on _compact_onset_tables and
accumulate_pulses_plain); the Hopper kernel itself is checked against
that plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py), and its decomposition (runs, warps, CTAs, cluster scans,
tile carries, staged table windows) is modelled here at a small size.
Tolerances: on the same onset mask the accumulations are float32 sums of
at most K terms of size <= 1 (atol 1e-5; the model 1e-6, since it shares
the plain version's LF arithmetic and differs only in the float64 phase's
association order); the full trains also decide their own onsets
(float64 phase here, TwoSum float32 phase in goofer_tpu), so pitches stay
off exact integer-period ties and the budget is 5e-3."""
import operator
from fractions import Fraction

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from goofer_tpu import config as j_config  # noqa: E402
from goofer_tpu.ops import pulse as j_pulse  # noqa: E402
from chip_smoke import exact_onsets, f0_with_onsets  # noqa: E402
from goofer_tpu_torch.ops import pulse  # noqa: E402
from goofer_tpu_torch.ops.cuda.pulse_kernel import tile_geometry  # noqa: E402

SR = 44100
MAIN = (0.02, 1.7, 0.8, True)       # pulse_train's LF shape
SUB = (0.02, 1.7, 1.0, False)       # subharm_pulse_train's


def _glide(n, gap=True):
    t = np.arange(n) / SR
    f0 = (200.0 * 2 ** (0.4 * np.sin(2 * np.pi * 2.0 * t))).astype(
        np.float32)
    if gap:
        f0[int(0.3 * n): int(0.45 * n)] = 0.0
    return f0


def _onset(f0):
    phase = np.cumsum(f0.astype(np.float64) / SR)
    k = np.floor(phase)
    return k > np.concatenate([[0.0], k[:-1]])


def _tables(onset, f0, valid, fallback, shape, spacing):
    return pulse._compact_onset_tables(
        torch.as_tensor(onset)[None], torch.as_tensor(f0)[None],
        torch.as_tensor(valid)[None], fallback, SR, *shape, spacing)


@pytest.mark.parametrize("shape", [MAIN, SUB], ids=["guard", "noguard"])
def test_compact_tables_match_jax(shape):
    n = 6000
    f0 = _glide(n)
    onset, valid = _onset(f0), f0 > 1e-6
    got = _tables(onset, f0, valid, 160.0, shape, 16)
    want = j_pulse._compact_onset_tables(
        n, jnp.asarray(onset), jnp.asarray(f0), jnp.asarray(valid), 160.0,
        SR, *shape, 16)
    # row, position, period: exact; the grid peak goes through sin/exp/cos,
    # whose float32 implementations differ by an ulp
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    np.testing.assert_allclose(got[4][0].numpy(), np.asarray(want[4]),
                               rtol=1e-6)


@pytest.mark.parametrize("k", [8, 16])
@pytest.mark.parametrize("shape", [MAIN, SUB], ids=["guard", "noguard"])
def test_plain_accumulation_matches_blocked(shape, k):
    """Same onset mask into both: the K-bounded sum equals goofer_tpu's
    production blocked accumulation."""
    n = 8192
    f0 = _glide(n)
    onset, valid = _onset(f0), f0 > 1e-6
    got = pulse.accumulate_pulses_plain(
        *_tables(onset, f0, valid, 160.0, shape, 16), *shape, k)[0]
    want = j_pulse._accumulate_pulses_blocked(
        n, jnp.asarray(onset), jnp.asarray(f0), jnp.asarray(valid), 160.0,
        SR, *shape, k, 16)
    assert float(got.abs().max()) > 0.5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_plain_accumulation_batch_rows_independent():
    n = 4096
    f0s = [_glide(n), np.full(n, 311.7, np.float32), np.zeros(n, np.float32)]
    onsets = np.stack([_onset(f) for f in f0s])
    f0b = np.stack(f0s)
    tabs = pulse._compact_onset_tables(
        torch.as_tensor(onsets), torch.as_tensor(f0b),
        torch.as_tensor(f0b > 1e-6), 160.0, SR, *MAIN, 16)
    batch = pulse.accumulate_pulses_plain(*tabs, *MAIN, 8)
    for b, f in enumerate(f0s):
        one = pulse.accumulate_pulses_plain(
            *_tables(onsets[b], f, f > 1e-6, 160.0, MAIN, 16), *MAIN, 8)[0]
        np.testing.assert_array_equal(batch[b].numpy(), one.numpy())
    assert float(batch[2].abs().max()) == 0.0


@pytest.mark.parametrize("case", ["const220.3", "const97.1", "glide"])
def test_pulse_train_matches_jax(case):
    n = 12000
    if case == "glide":
        f0 = _glide(n)
    else:
        f0 = np.full(n, float(case[5:]), dtype=np.float32)
        f0[: n // 8] = 0.0
    got = pulse.pulse_train(torch.as_tensor(f0), SR, max_overlap=16,
                            min_spacing=16)
    want = j_pulse.pulse_train(jnp.asarray(f0), SR, max_overlap=16,
                               min_spacing=16)
    assert got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3)


def test_pulse_train_silence():
    got = pulse.pulse_train(torch.zeros(3000), SR)
    assert float(got.abs().max()) == 0.0


def test_subharm_pulse_train_matches_jax():
    n = 12000
    f0 = _glide(n, gap=False) * np.float32(1.013)
    mask = np.ones(n, dtype=np.float32)
    mask[4000:5500] = 0.0
    got = pulse.subharm_pulse_train(torch.as_tensor(f0), SR,
                                    torch.as_tensor(mask), [12.0], 0.9)
    want = j_pulse.subharm_pulse_train(jnp.asarray(f0), SR,
                                       jnp.asarray(mask), [12.0], 0.9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3)


def test_subharm_pulse_train_rows_match_single():
    """(B, n) rows with per-row weights: each row is peak-normalized over
    itself (a silent-gated row stays zero), equal to the row alone."""
    n = 12000
    f0 = np.stack([_glide(n, gap=False) * np.float32(s)
                   for s in (1.013, 0.61, 1.4)])
    mask = np.ones((3, n), dtype=np.float32)
    mask[0, 4000:5500] = 0.0
    mask[1] = 0.0
    weight = np.array([0.9, 0.5, 0.2], np.float32)
    got = pulse.subharm_pulse_train(torch.as_tensor(f0), SR,
                                    torch.as_tensor(mask), [12.0],
                                    torch.as_tensor(weight))
    assert got.shape == (3, n) and float(got[1].abs().max()) == 0.0
    for b in range(3):
        one = pulse.subharm_pulse_train(torch.as_tensor(f0[b]), SR,
                                        torch.as_tensor(mask[b]), [12.0],
                                        float(weight[b]))
        np.testing.assert_allclose(got[b].numpy(), one.numpy(), atol=1e-6)


@pytest.mark.slow
@pytest.mark.parametrize("f0_hz", [220.3, 97.1])
def test_plain_accumulation_matches_pallas_interpret(f0_hz):
    """Against the Pallas TPU kernel itself, in interpret mode (~40 s)."""
    n = 4096
    f0 = np.full(n, f0_hz, dtype=np.float32)
    f0[: n // 8] = 0.0
    onset, valid = _onset(f0), f0 > 1e-6
    got = pulse.accumulate_pulses_plain(
        *_tables(onset, f0, valid, j_config.PULSE_FALLBACK_F0, MAIN, 16),
        *MAIN, 16)[0]
    want = j_pulse._accumulate_pulses_pallas(
        n, jnp.asarray(onset), jnp.asarray(f0), jnp.asarray(valid),
        j_config.PULSE_FALLBACK_F0, SR, *MAIN, 16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _creep_f0(n=600):
    """Dyadic f0 at sr = 2^16, so every partial phase sum is exact in any
    association order: 512 Hz to an onset at 127, 896 Hz to phase
    2 - 2^-6 at 199, one valid sample of 1024 - 2^-14 Hz at 200 to
    2 - 2^-30, then f0 = 2^-20 (not > 1e-6: invalid) creeping 2^-36 a
    sample to an onset exactly at 264.  That onset's period comes from the
    last valid f0, two tiles and CTAs back in the model (T0 = 64 samples;
    a stale carry gives 73, 128 or the fallback's 410), then 320 Hz."""
    f0 = np.empty(n, np.float32)
    f0[:128] = 512.0
    f0[128:200] = 896.0
    f0[200] = 1024.0 - 2.0 ** -14
    f0[201:400] = 2.0 ** -20
    f0[400:] = 320.0
    return f0


def _hs_scan(x, axis, combine):
    """Inclusive Hillis-Steele scan along ``axis``, as the kernel's
    shuffles run it: step ``off`` combines element i - off (earlier) with
    element i (later)."""
    x = np.moveaxis(x, axis, -1).copy()
    off = 1
    while off < x.shape[-1]:
        nxt = x.copy()
        nxt[..., off:] = combine(x[..., :-off], x[..., off:])
        x = nxt
        off *= 2
    return np.moveaxis(x, -1, axis)


def _exclusive(inc, axis, identity):
    first = np.full_like(np.take(inc, [0], axis=axis), identity)
    return np.concatenate([first, np.delete(inc, -1, axis=axis)], axis=axis)


def _cluster_scan(vals, carry, combine, identity, grid):
    """The kernel's scan of per-run values over lanes, the warps of a CTA
    and the CTAs of the cluster, with the tile's carry entering at rank 0.
    Returns each run's carry-in, each CTA's carry-in and inclusive total,
    and the next tile's carry."""
    lane_inc = _hs_scan(vals.reshape(grid), 2, combine)
    lane_ex = _exclusive(lane_inc, 2, identity)
    warp_inc = _hs_scan(lane_inc[..., -1], 1, combine)
    warp_ex = _exclusive(warp_inc, 1, identity)
    cta_inc = _hs_scan(warp_inc[:, -1], 0, combine)
    cta_in = np.array([carry] + [combine(carry, c) for c in cta_inc[:-1]],
                      vals.dtype)
    cta_end = np.array([combine(carry, c) for c in cta_inc], vals.dtype)
    run_in = combine(combine(cta_in[:, None, None], warp_ex[..., None]),
                     lane_ex)
    return run_in.reshape(-1), cta_in, cta_end, cta_end[-1]


def _last_of(earlier, later):
    return np.where(later > 0, later, earlier)


def _kernel_model(f0, gate, sr, scale, fallback, shape, max_overlap,
                  min_spacing, cluster=4, warps=4, lanes=4, run=4):
    """A NumPy model of csrc/pulse_accumulate.cu's decomposition at a small
    size: CTAs of warps x lanes runs of ``run`` samples, the row walked in
    the kernel's tiles (tile_geometry: the fewest of at most 256 samples,
    split evenly over the CTAs in warp spans).  Per tile: each run's float64 phase advance and last valid f0, scanned over
    lanes, warps and CTAs with the tile carry at rank 0; each run's onsets
    from its phase carry-in; the onset count scanned the same way; the
    onset rows written to a table (NaN until written: reading an unwritten
    row fails); each CTA's window of rows [gen_in - K, min(gen_end, M) - 1],
    staged when it fits the shared stage (reading outside it fails), else
    read from the table; and each sample's K most recent rows summed in
    float32 in the plain version's order, walking back until the row's
    offset reaches the window's largest T0 (8192 unstaged).  Returns the
    (B, n) train and stats: how many CTA tiles ran staged and unstaged,
    and each row's onset count."""
    Ra, Rg, Rk, guard = shape
    f0 = np.asarray(f0, np.float32)
    batch, n = f0.shape
    m = n // min_spacing + 2
    grid = (cluster, warps, lanes)
    runs = cluster * warps * lanes
    seg_max = warps * lanes * run
    tile, seg = tile_geometry(n, cluster, lanes * run, seg_max)
    window = (seg_max + seg_max // 32) // 4
    out = np.zeros((batch, n), np.float32)
    stats = {"staged": 0, "unstaged": 0, "onsets": []}
    k_of = np.arange(run)[None, :]
    for b in range(batch):
        tab = np.full((m, 4), np.nan, np.float32)
        carry_ph, carry_lv, carry_gen, carry_dead = 0, np.float32(0.0), 0, False
        for t0 in range(0, n, tile):
            cta = np.arange(runs) // (warps * lanes)
            seg0 = t0 + cta * seg
            lo = seg0 + run * (np.arange(runs) % (warps * lanes))
            live = k_of < np.clip(np.minimum(n, seg0 + seg) - lo, 0,
                                  run)[:, None]
            idx = np.minimum(lo[:, None] + k_of, n - 1)

            def load(x):
                return np.where(live, x[b][idx], np.float32(0.0))

            v = load(f0)
            s = v * np.float32(scale)
            if gate is None:
                acc = live
                valid = live & (s > np.float32(1e-6))
            else:
                acc = live & (load(np.asarray(gate, np.float32)) > 0) & (
                    v > 0) & (s >= np.float32(1e-2))
                valid = acc
            with np.errstate(invalid="ignore"):
                d = np.where(acc, s.astype(np.float64) / sr, 0.0)
                step_ok = np.abs(d) < 2.0 ** 32
            # each step as an exact fixed-point int with 64 fraction bits
            q = np.zeros((runs, run), object)
            for r, k in zip(*np.nonzero(acc & step_ok)):
                q[r, k] = int(d[r, k] * 2.0 ** 64)
            stops = acc & ~step_ok

            ph = q.sum(axis=1)
            lv = np.zeros(runs, np.float32)
            for k in range(run):
                lv = np.where(valid[:, k], s[:, k], lv)
            ph_in, _, _, carry_ph = _cluster_scan(
                ph, carry_ph, operator.add, 0, grid)
            lv_in, _, _, carry_lv = _cluster_scan(
                lv, carry_lv, _last_of, np.float32(0.0), grid)
            dead, _, _, carry_dead = _cluster_scan(
                stops.any(axis=1), carry_dead, np.logical_or, False, grid)

            onset = np.zeros((runs, run), bool)
            p = ph_in.copy()
            fl = np.array([int(x) >> 64 for x in p], object)
            for k in range(run):
                step = acc[:, k] & ~dead & step_ok[:, k]
                stop = acc[:, k] & ~dead & ~step_ok[:, k]
                p = np.where(step, p + q[:, k], p)
                f = np.array([int(x) >> 64 for x in p], object)
                onset[:, k] = (step & (f > fl).astype(bool)) | (
                    stop & (d[:, k] > 0))
                fl = np.where(step, f, fl)
                dead = dead | stop
            gen_in, cta_gen_in, cta_gen_end, carry_gen = _cluster_scan(
                onset.sum(1), carry_gen, np.add, 0, grid)

            last = lv_in.copy()
            g = gen_in.copy()
            for k in range(run):
                last = np.where(valid[:, k], s[:, k], last)
                on = onset[:, k]
                keep = on & (g < m)
                if keep.any():
                    f0_at = torch.as_tensor(np.where(
                        last[keep] > 0, last[keep], np.float32(fallback)))
                    t = 1.0 / torch.clamp(f0_at, min=1e-6)
                    t0s = torch.clamp(torch.round(sr * t), 3, 8192)
                    norm = pulse._grid_peak(t0s, t, Ra, Rg, Rk, guard)
                    tab[g[keep]] = np.stack([
                        (lo[keep] + k).astype(np.float32), t0s.numpy(),
                        t.numpy(), norm.numpy()], axis=1)
                g = g + on

            w_lo = np.maximum(0, cta_gen_in - max_overlap)
            w_n = np.minimum(cta_gen_end, m) - w_lo
            staged = w_n <= window
            wins = [tab[w_lo[c]:w_lo[c] + max(w_n[c], 0)].copy()
                    for c in range(cluster)]
            reach = np.array([
                (wins[c][:, 1].max(initial=0.0) if staged[c] else 8192.0)
                for c in range(cluster)], np.float32)
            stats["staged"] += int(staged.sum())
            stats["unstaged"] += int((~staged).sum())

            res = np.zeros((runs, run), np.float32)
            g = gen_in.copy()
            for k in range(run):
                g = g + onset[:, k]
                t = (lo + k).astype(np.float32)
                acc_k = np.zeros(runs, np.float32)
                done = np.zeros(runs, bool)
                for kk in range(max_overlap):
                    j = g - 1 - kk
                    ok = live[:, k] & (j >= 0) & (j < m) & ~done
                    e = np.zeros((runs, 4), np.float32)
                    for r in np.nonzero(ok)[0]:
                        c = cta[r]
                        if staged[c]:
                            at = j[r] - w_lo[c]
                            assert 0 <= at < w_n[c], "row outside the window"
                            e[r] = wins[c][at]
                        else:
                            e[r] = tab[j[r]]
                    assert not np.isnan(e[ok]).any(), "unwritten table row"
                    offs = t - e[:, 0]
                    stop = ok & (offs >= reach[cta])
                    done |= stop
                    hit = ok & ~stop & (offs >= 0) & (offs < e[:, 1])
                    if hit.any():
                        u = torch.as_tensor(offs[hit] / e[hit, 1])
                        val = (pulse.lf_pulse_value(
                            u, torch.as_tensor(e[hit, 2]), Ra, Rg, Rk, guard)
                            / torch.as_tensor(e[hit, 3])).numpy()
                        acc_k[hit] = acc_k[hit] + val
                res[:, k] = acc_k
            out[b, idx[live]] = res[live]
        stats["onsets"].append(int(carry_gen))
    return out, stats


def _model_cases():
    """(name, f0 (B, n), gate or None, sr, scale, fallback, shape, K,
    min_spacing)."""
    rng = np.random.default_rng(7)
    edges = [3, 4, 8, 15, 16, 17, 31, 32, 47, 64, 96, 127, 128, 129, 200,
             255, 256, 257, 320, 383, 384, 450, 511, 512, 600]
    n_gap = 900
    # an onset near sample 111 at 31.7 Hz (T0 = 1391 samples), then an
    # unvoiced stretch three tiles long under its pulse, then 300 Hz
    gap = np.full(n_gap, 300.0 + 5.0 * rng.random(), np.float32)
    gap[:100] = 437.3
    gap[100:120] = 31.7
    gap[120:520] = 0.0
    dense = (3000.0 + 2000.0 * rng.random(600)).astype(np.float32)
    n_sub = 520             # tiles of 192: CTA segments of 48 samples
    t = np.arange(n_sub) / SR
    glide = (200.0 * 2 ** (0.4 * np.sin(2 * np.pi * 9.0 * t))).astype(
        np.float32)
    mask = np.ones(n_sub, np.float32)
    mask[150:330] = 0.0
    mask[480:500] = 0.0
    rows = np.stack([_glide(640), np.full(640, 311.7, np.float32),
                     np.zeros(640, np.float32)])
    stops = _glide(700)
    stops[300] = np.inf     # an onset there, none after: the phase is inf
    stops[450] = np.nan
    return [
        ("edges", f0_with_onsets(edges, 700)[None], None, SR, 1.0, 160.0,
         MAIN, 8, 16),
        ("unvoiced_gap", gap[None], None, SR, 1.0, 160.0, MAIN, 3, 16),
        ("dense_past_m", dense[None], None, SR, 1.0, 160.0, MAIN, 16, 32),
        ("gated", glide[None], mask[None], SR, 2.0, 320.0, SUB, 8, 8),
        ("batch3_silent", rows, None, SR, 1.0, 160.0, MAIN, 8, 16),
        ("creep_last_valid", _creep_f0()[None], None, 65536.0, 1.0, 160.0,
         MAIN, 4, 16),
        ("nonfinite_steps", stops[None], None, SR, 1.0, 160.0, MAIN, 8, 16),
    ]


@pytest.mark.parametrize("case", _model_cases(), ids=lambda c: c[0])
def test_kernel_decomposition_model(case):
    """The card kernel's runs, warps, CTAs, cluster scans, tile carries and
    table windows, modelled at tiles of up to 256 samples, against the plain
    version (onsets at run, warp, CTA and tile edges; an unvoiced stretch longer
    than a tile under a sounding pulse; onsets denser than min_spacing,
    past row M; the gated pass; three rows, one silent; an onset whose
    period comes from a last valid f0 two tiles back; an inf and a NaN
    step)."""
    name, f0, gate, sr, scale, fallback, shape, k, spacing = case
    got, stats = _kernel_model(f0, gate, sr, scale, fallback, shape, k,
                               spacing)
    want = pulse.pulse_pass_plain(
        torch.as_tensor(f0), None if gate is None else torch.as_tensor(gate),
        sr, scale, fallback, *shape, k, spacing).numpy()
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-6)
    assert np.abs(want).max() > 0.5
    if name == "edges":
        phase = np.cumsum(f0[0].astype(np.float64) / sr)
        assert np.nonzero(pulse._onsets_from_phase(
            torch.as_tensor(phase)).numpy())[0].tolist() == [
                3, 4, 8, 15, 16, 17, 31, 32, 47, 64, 96, 127, 128, 129, 200,
                255, 256, 257, 320, 383, 384, 450, 511, 512, 600]
    if name == "dense_past_m":
        # rows past M occur, and windows overflow the stage
        assert int(pulse._onsets_from_phase(torch.cumsum(
            torch.as_tensor(f0).double() / sr, -1)).sum()) > 600 // 32 + 2
        assert stats["unstaged"] > 0
    else:
        assert stats["staged"] > 0
    if name == "unvoiced_gap":
        # the first pulse still sounds two tiles into the stretch
        assert float(np.abs(want[0, 300:520]).max()) > 0.0
    if name == "batch3_silent":
        assert float(np.abs(got[2]).max()) == 0.0
    if name == "creep_last_valid":
        assert abs(float(got[0, 264]) - 0.0) < 1e-6 and got[0, 265] > 0.0
        t0 = pulse.pulse_pass_tables(torch.as_tensor(f0), None, sr, scale,
                                     fallback, *shape, spacing)[2]
        assert float(t0[0, 1]) == 64.0


@pytest.mark.parametrize("gated", [False, True], ids=["main", "gated"])
def test_kernel_model_matches_jax(gated):
    """The model against goofer_tpu's pulse_train and subharm_pulse_train
    on pitches away from phase ties, over several tiles."""
    n = 1300
    if not gated:
        f0 = _glide(n)
        got, _ = _kernel_model(f0[None], None, SR, 1.0,
                               j_config.PULSE_FALLBACK_F0, MAIN, 16, 16)
        want = j_pulse.pulse_train(jnp.asarray(f0), SR, max_overlap=16,
                                   min_spacing=16)
        np.testing.assert_allclose(got[0], np.asarray(want), atol=5e-3)
        return
    f0 = _glide(n, gap=False) * np.float32(1.013)
    mask = np.ones(n, dtype=np.float32)
    mask[400:700] = 0.0
    ratio = 2.0 ** (12.0 / 12.0)
    train, _ = _kernel_model(f0[None], mask[None], SR, ratio,
                             j_config.PULSE_FALLBACK_F0 * ratio, SUB, 8, 8)
    total = train[0] * mask
    got = total / np.abs(total).max() * 0.9
    want = j_pulse.subharm_pulse_train(jnp.asarray(f0), SR,
                                       jnp.asarray(mask), [12.0], 0.9)
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-3)


def _fma(a, b, c):
    """a * b + c rounded once to float64."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


@pytest.mark.parametrize("sr", [44100.0, 48000.0, 65536.0])
def test_phase_step_matches_division(sr):
    """The kernel's float64 phase step (csrc/pulse_accumulate.cu:
    phase_step): q0 = f * (1 / sr), then q0 + (f - q0 sr) / sr by two FMAs,
    is the correctly rounded f / sr for float32 f across the range (zero,
    subnormal, voice, the largest float32, negative)."""
    rng = np.random.default_rng(int(sr))
    f = np.concatenate([
        rng.uniform(0.0, 50000.0, 20000), rng.uniform(0.0, 1.0, 2000),
        np.exp(rng.uniform(-100.0, 80.0, 1000)), -rng.uniform(0.0, 1e4, 500),
        [0.0, 1e-45, 3.4e38, 1e-6, 2.0 ** -20, 160.0, 220.3, 97.1]])
    inv = 1.0 / sr
    for a in f.astype(np.float32).astype(np.float64):
        q0 = a * inv
        assert _fma(_fma(-q0, sr, a), inv, q0) == a / sr, a


def test_kernel_model_counts_tied_crossings_once():
    """A constant 220 Hz row at 44.1 kHz: its phase comes within 1e-13 of
    an integer every 2205 samples, at a run edge of the model.  The model
    (exact phase) fires each crossing once, as the plain version does
    (float64 cumsum), and matches the plain accumulation on exact-phase
    onsets; a float64 phase summed per run and by the scan would count
    such a crossing twice or not at all."""
    n = 4500
    f0 = np.full(n, 220.0, np.float32)
    got, stats = _kernel_model(f0[None], None, SR, 1.0, 160.0, MAIN, 8, 128)
    phase = torch.cumsum(torch.as_tensor(f0).double() / SR, -1)
    assert float((phase - torch.round(phase)).abs()[2000:2400].min()) < 1e-12
    onset = exact_onsets(f0, SR)
    assert stats["onsets"] == [int(onset.sum())] == [
        int(pulse._onsets_from_phase(phase).sum())]
    f0_t = torch.as_tensor(f0)[None]
    tables = pulse._compact_onset_tables(
        torch.as_tensor(onset)[None], f0_t, f0_t > 1e-6, 160.0, SR, *MAIN,
        128)
    want = pulse.accumulate_pulses_plain(*tables, *MAIN, 8)[0].numpy()
    np.testing.assert_allclose(got[0], want, rtol=0.0, atol=1e-6)
