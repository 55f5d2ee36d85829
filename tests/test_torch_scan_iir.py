"""goofer_tpu_torch's one-pole cascades and fry envelope shift vs
goofer_tpu's, and both against the reference loops, on the CPU.

The same seeded NumPy inputs go through the JAX function, its port (the
cascade kernel's plain version on CPU tensors) and the float64 loops of
tests/oracles.py.  Tolerances: the reference suite's rtol 5e-3 / atol
1e-4 against the loops (tests/test_ops.py: float32 recurrences in
another association order; HP cascades near alpha = 1 amplify rounding);
port vs JAX rtol 1e-3 / atol 2e-5, two float32 scans of the same
recurrences; the fry shift is a float32 lerp (atol 2e-6, the banded-vs-
gather equivalence of tests/test_envelope.py).  The model of the card
kernel's decomposition is held to the plain version within the card's
kernel tolerance, 1e-4 x max|x|: two float32 scans of the same
recurrences in other association orders."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from goofer_tpu.ops import envelope as j_env  # noqa: E402
from goofer_tpu.ops import scan_iir as j_scan  # noqa: E402
from goofer_tpu_torch.ops import envelope, scan_iir  # noqa: E402
from goofer_tpu_torch.ops.cuda.cascade_kernel import one_pole_cascade  # noqa: E402
from tests import oracles as o  # noqa: E402

SR = 44100


def _signal(seed, n, voiced=0.7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    f0 = np.where(rng.random(n) < voiced,
                  220.0 + 50 * np.sin(np.arange(n) / 200), 0.0)
    return x, f0.astype(np.float32)


def _jax_butter(x, f0, factor, order, btype):
    """goofer_tpu's filter; order 12 is its order 6 applied twice, as
    the su and sj layers call it."""
    y = jnp.asarray(x)
    for part in ((6, 6) if order == 12 else (order,)):
        y = j_scan.dynamic_butter_filter(y, jnp.asarray(f0), SR, factor,
                                         order=part, btype=btype)
    return np.asarray(y)


def _oracle_butter(x, f0, factor, order, btype):
    y = x
    for part in ((6, 6) if order == 12 else (order,)):
        y = o.o_dynamic_butter(y, f0, SR, factor, part, btype)
    return y


@pytest.mark.parametrize("btype", ["lowpass", "highpass"])
@pytest.mark.parametrize("order", [1, 4, 6, 12])
def test_dynamic_butter_matches_jax_and_loop(btype, order):
    x, f0 = _signal(order, 2000)
    got = scan_iir.dynamic_butter_filter(torch.as_tensor(x),
                                         torch.as_tensor(f0), SR, 1.5,
                                         order=order, btype=btype).numpy()
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_allclose(got, _oracle_butter(x, f0, 1.5, order, btype),
                               rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(got, _jax_butter(x, f0, 1.5, order, btype),
                               rtol=1e-3, atol=2e-5)


@pytest.mark.parametrize("btype,factor", [("highpass", 200.0),
                                          ("lowpass", 300.0)])
def test_dynamic_butter_unvoiced_constant_cutoff(btype, factor):
    """No voiced sample: the raw factor is the cutoff in Hz, unsmoothed
    (the fry blend's form)."""
    x, _ = _signal(3, 800)
    f0 = np.zeros(800, np.float32)
    got = scan_iir.dynamic_butter_filter(torch.as_tensor(x),
                                         torch.as_tensor(f0), SR, factor,
                                         order=6, btype=btype).numpy()
    np.testing.assert_allclose(got, o.o_dynamic_butter(
        x, f0, SR, factor, 6, btype), rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(got, _jax_butter(x, f0, factor, 6, btype),
                               rtol=1e-3, atol=2e-5)


def test_dynamic_butter_resamples_f0_and_stacks_rows():
    """A short f0 track is resampled to the signal; a (B, n) stack shares
    it, each row filtered as on its own."""
    x, _ = _signal(4, 1500)
    x2 = np.stack([x, x[::-1].copy()])
    f0 = (180.0 + 40 * np.sin(np.arange(37) / 5.0)).astype(np.float32)
    got = scan_iir.dynamic_butter_filter(torch.as_tensor(x2),
                                         torch.as_tensor(f0), SR, 2.0,
                                         order=4, btype="highpass").numpy()
    for row in range(2):
        want = np.asarray(j_scan.dynamic_butter_filter(
            jnp.asarray(x2[row]), jnp.asarray(f0), SR, 2.0, order=4,
            btype="highpass"))
        np.testing.assert_allclose(got[row], want, rtol=1e-3, atol=2e-5)


@pytest.mark.parametrize("fc", [300.0, 40.0])
def test_one_pole_highpass(fc):
    x, _ = _signal(5, 3000)
    got = scan_iir.one_pole_highpass(torch.as_tensor(x), SR, fc).numpy()
    np.testing.assert_allclose(got, o.o_one_pole_hp(x, SR, fc),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(j_scan.one_pole_highpass(jnp.asarray(x), SR, fc)),
        rtol=1e-3, atol=2e-5)
    assert not scan_iir.one_pole_highpass(torch.as_tensor(x), SR,
                                          0.0).any()


@pytest.mark.parametrize("n", [1, 2, 5, 1025])
def test_cascade_plain_short_rows(n):
    """The doubling scan at lengths around its power-of-two steps
    against the sequential recurrence."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((2, n)).astype(np.float32)
    alpha = rng.uniform(0.5, 0.99, n).astype(np.float32)
    for btype in ("lowpass", "highpass"):
        got = one_pole_cascade(torch.as_tensor(x), torch.as_tensor(alpha),
                               3, btype).numpy()
        want = x.astype(np.float64)
        for _ in range(3):
            y = np.zeros_like(want)
            prev = np.zeros(2)
            x_prev = want[:, 0].copy()
            for i in range(n):
                if btype == "lowpass":
                    prev = prev + alpha[i] * (want[:, i] - prev)
                else:
                    prev = alpha[i] * (prev + want[:, i] - x_prev)
                    x_prev = want[:, i]
                y[:, i] = prev
            want = y
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _scan_maps(a, b, axis):
    """Inclusive scan of the maps y -> a y + b along ``axis``, float32."""
    a = np.moveaxis(a, axis, -1).copy()
    b = np.moveaxis(b, axis, -1).copy()
    for i in range(1, a.shape[-1]):
        b[..., i] = a[..., i] * b[..., i - 1] + b[..., i]
        a[..., i] = a[..., i] * a[..., i - 1]
    return np.moveaxis(a, -1, axis), np.moveaxis(b, -1, axis)


def _exclusive(inc, axis, identity):
    """Shift an inclusive scan one place along ``axis``."""
    first = np.full_like(np.take(inc, [0], axis=axis), identity)
    return np.concatenate([first, np.delete(inc, -1, axis=axis)], axis=axis)


def _kernel_model(x, alpha, order, btype, cluster=2, warps=2, lanes=4,
                  run=3):
    """A float32 NumPy model of csrc/one_pole_cascade.cu's decomposition
    at a small size.  A row is walked in tiles of cluster x warps x lanes
    runs of ``run`` samples.  Per tile and stage: each run's map from
    y = 0; inclusive scans over the lanes of a warp, the warps of a CTA
    and the CTAs of the cluster; the stage's tile carry entering at rank
    0; the re-run from each carry-in; and as the next stage's HP boundary
    value, this stage's carry-in (x[-1] := x[0] at the row's start)."""
    hp = btype == "highpass"
    rows, n = x.shape
    alpha = np.broadcast_to(alpha, x.shape)
    runs = cluster * warps * lanes
    tile = runs * run
    out = np.zeros_like(x)
    grid = (cluster, warps, lanes)
    for r in range(rows):
        carries = np.zeros(order, np.float32)
        for t0 in range(0, n, tile):
            lo = t0 + run * np.arange(runs)
            cnt = np.clip(n - lo, 0, run)
            v = np.zeros((runs, run), np.float32)
            al = np.zeros((runs, run), np.float32)
            seg = x[r, t0:t0 + tile]
            v.reshape(-1)[:seg.size] = seg
            al.reshape(-1)[:seg.size] = alpha[r, t0:t0 + tile]
            xp = np.where(lo == 0, v[:, 0], x[r, np.clip(lo - 1, 0, n - 1)])
            for s in range(order):
                y = np.zeros(runs, np.float32)
                a = np.ones(runs, np.float32)
                xq = xp.copy()
                for k in range(run):
                    live = k < cnt
                    if hp:
                        y = np.where(live, al[:, k] * ((y + v[:, k]) - xq), y)
                        a = np.where(live, a * al[:, k], a)
                        xq = np.where(live, v[:, k], xq)
                    else:
                        y = np.where(live, y + al[:, k] * (v[:, k] - y), y)
                        a = np.where(live, a * (1.0 - al[:, k]), a)
                la, lb = _scan_maps(a.reshape(grid), y.reshape(grid), 2)
                wa, wb = _scan_maps(la[..., -1], lb[..., -1], 1)
                ca, cb = _scan_maps(wa[:, -1], wb[:, -1], 0)
                carry = carries[s]
                y_cta = _exclusive(ca, 0, 1.0) * carry + _exclusive(cb, 0, 0.0)
                y_warp = (_exclusive(wa, 1, 1.0) * y_cta[:, None]
                          + _exclusive(wb, 1, 0.0))
                y_in = (_exclusive(la, 2, 1.0) * y_warp[..., None]
                        + _exclusive(lb, 2, 0.0)).reshape(-1)
                carries[s] = ca[-1] * carry + cb[-1]
                y = y_in.copy()
                xq = xp.copy()
                for k in range(run):
                    live = k < cnt
                    if hp:
                        y_new = al[:, k] * ((y + v[:, k]) - xq)
                        xq = np.where(live, v[:, k], xq)
                    else:
                        y_new = y + al[:, k] * (v[:, k] - y)
                    y = np.where(live, y_new, y)
                    v[:, k] = np.where(live, y, v[:, k])
                xp = np.where(lo == 0, v[:, 0], y_in)
            out[r, t0:t0 + tile] = v.reshape(-1)[:min(tile, n - t0)]
    return out


@pytest.mark.parametrize("btype", ["lowpass", "highpass"])
@pytest.mark.parametrize("order", [1, 2, 6, 12])
def test_kernel_decomposition_model(btype, order):
    """The card kernel's tiles, CTAs, warps and runs with their per-stage
    carries and HP boundary values, modelled at 48-sample tiles on rows
    of 3 ragged tiles with steps at a run and a tile boundary, against
    the plain version and goofer_tpu's dynamic_butter_filter."""
    x, f0 = _signal(20 + order, 131)
    x[45:] += 2.0       # a run boundary inside the first tile
    x[96:] -= 1.0       # a tile boundary
    rows = np.stack([x, x[::-1].copy()])
    factor = 1.5
    alpha = scan_iir.butter_alpha(torch.as_tensor(f0), 131, SR, factor,
                                  btype).numpy()
    got = _kernel_model(rows, alpha, order, btype)
    plain = scan_iir.one_pole_cascade_plain(
        torch.as_tensor(rows), torch.as_tensor(alpha), order, btype).numpy()
    np.testing.assert_allclose(got, plain, rtol=0.0,
                               atol=1e-4 * np.abs(rows).max())
    np.testing.assert_allclose(got[0], _jax_butter(x, f0, factor, order,
                                                   btype),
                               rtol=1e-3, atol=2e-5)


def test_cascade_wrapper_cpu_counts_no_launch():
    before = one_pole_cascade.launches
    x = torch.zeros((1, 64))
    out = one_pole_cascade(x, torch.full((64,), 0.9), 12, "highpass")
    assert out.shape == (1, 64) and not out.any()
    assert one_pole_cascade.launches == before
    with pytest.raises(ValueError, match="btype"):
        one_pole_cascade(x, torch.full((64,), 0.9), 2, "bandpass")


@pytest.mark.parametrize("t", [1, 40])
def test_fry_env_shift_matches_jax(t):
    rng = np.random.default_rng(8)
    env = rng.random((513, t)).astype(np.float32)
    w = np.clip(rng.uniform(-0.3, 1.2, t), 0.0, 1.0).astype(np.float32)
    w[: t // 3] = 0.0     # frames outside the fry region stay as they are
    got = envelope.fry_env_shift(torch.as_tensor(env), torch.as_tensor(w),
                                 0.92).numpy()
    want = np.asarray(j_env.fry_env_shift(jnp.asarray(env), jnp.asarray(w),
                                          0.92))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0.0)
    np.testing.assert_array_equal(got[:, : t // 3], env[:, : t // 3])


def _batch_rows():
    """Three rows: voiced with gaps, fully silent, fully voiced."""
    xs, f0s = zip(*(_signal(40 + i, 2000) for i in range(3)))
    f0 = np.stack(f0s)
    f0[1] = 0.0
    f0[2] = 180.0
    return np.stack(xs), f0


@pytest.mark.parametrize("btype", ["lowpass", "highpass"])
def test_butter_alpha_rows_match_vmap(btype):
    """(B, n) f0 with one silent and one voiced row: the any-voiced test
    and the cutoff are per row, as goofer_tpu's under vmap."""
    _, f0 = _batch_rows()
    factor = np.array([1.0, 200.0, 2.5], np.float32)
    got = scan_iir.butter_alpha(torch.as_tensor(f0), 2000, SR,
                                torch.as_tensor(factor), btype).numpy()
    assert got.shape == f0.shape
    for b in range(3):
        one = scan_iir.butter_alpha(torch.as_tensor(f0[b]), 2000, SR,
                                    float(factor[b]), btype).numpy()
        np.testing.assert_array_equal(got[b], one)
    # the silent row holds the raw cutoff, in Hz
    w = 2.0 * np.pi * 200.0
    want = w / (w + SR) if btype == "lowpass" else SR / (w + SR)
    np.testing.assert_allclose(got[1], want, rtol=1e-6)


@pytest.mark.parametrize("btype,order", [("lowpass", 4), ("highpass", 6)])
def test_dynamic_butter_rows_match_vmap(btype, order):
    """(B, n) rows, each with its own f0 row and cutoff factor, in one
    cascade call, against goofer_tpu under jax.vmap."""
    x, f0 = _batch_rows()
    factor = np.array([1.0, 200.0, 2.5], np.float32)
    before = one_pole_cascade.launches
    got = scan_iir.dynamic_butter_filter(
        torch.as_tensor(x), torch.as_tensor(f0), SR, torch.as_tensor(factor),
        order=order, btype=btype).numpy()
    assert one_pole_cascade.launches == before      # CPU: the plain version
    want = np.asarray(jax.vmap(
        lambda a, f, c: j_scan.dynamic_butter_filter(
            a, f, SR, c, order=order, btype=btype))(
        jnp.asarray(x), jnp.asarray(f0), jnp.asarray(factor)))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-5)


def test_cascade_pairs_share_alpha():
    """The fry pair batched: a (2, B, n) stack with one shared (n,)
    coefficient row is 2B rows of one call, equal to each row alone."""
    x, _ = _batch_rows()
    pair = torch.as_tensor(np.stack([x, x[::-1] * 0.5]))
    alpha = scan_iir.butter_alpha(torch.ones(2000), 2000, SR, 200.0,
                                  "highpass")
    got = scan_iir.cascade(pair, alpha, 6, "highpass")
    assert got.shape == pair.shape
    for i in range(2):
        for b in range(3):
            np.testing.assert_array_equal(
                got[i, b].numpy(),
                scan_iir.cascade(pair[i, b], alpha, 6, "highpass").numpy())


def test_one_pole_highpass_rows():
    x, _ = _batch_rows()
    got = scan_iir.one_pole_highpass(torch.as_tensor(x), SR, 300.0).numpy()
    want = np.asarray(jax.vmap(lambda a: j_scan.one_pole_highpass(
        a, SR, 300.0))(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-5)
