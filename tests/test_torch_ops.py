"""goofer_tpu_torch ops vs their goofer_tpu counterparts on the CPU.

The same seeded NumPy inputs go through the JAX function and its port.
Tolerances: interpolation, filters, envelope transforms and the
deterministic jitter forms are float32 elementwise chains (atol 1e-5);
the STFT/iSTFT sum in another FFT order (1e-4 x peak); the knot decode
(a two-tap lerp in the port, a float32 matrix product in goofer_tpu)
followed by exp is held side by side, each side to the float64 result
and the two to each other, within float32's rounding bound (~1.5e-6
relative, doubled between the sides)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from goofer_tpu.ops import envelope as j_env  # noqa: E402
from goofer_tpu.ops import filters as j_filters  # noqa: E402
from goofer_tpu.ops import interp as j_interp  # noqa: E402
from goofer_tpu.ops import jitter as j_jitter  # noqa: E402
from goofer_tpu.ops import stft as j_stft  # noqa: E402
from goofer_tpu_torch.ops import envelope, filters, interp, jitter, noise, stft  # noqa: E402

ATOL = 1e-5
SR = 44100


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("num,start,stop", [(513, 0.0, 22050.0),
                                            (7, 0.0, 1.0), (1, 3.0, 5.0),
                                            (40000, 0.0, 9999.0)])
def test_linspace_matches_jnp(num, start, stop):
    """One float32 ulp: XLA's CPU division is not correctly rounded."""
    np.testing.assert_array_max_ulp(
        interp.linspace(start, stop, num).numpy(),
        np.asarray(jnp.linspace(start, stop, num, dtype=jnp.float32)),
        maxulp=1)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_gather_lerp(axis):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((37, 53)).astype(np.float32)
    n = x.shape[axis]
    pos = rng.uniform(-3.0, n + 3.0, 101).astype(np.float32)
    _close(interp.gather_lerp(_t(x), _t(pos), axis=axis),
           j_interp.gather_lerp(jnp.asarray(x), jnp.asarray(pos), axis=axis))


@pytest.mark.parametrize("n,target", [(50, 173), (173, 50), (1, 9), (9, 9)])
def test_resample_1d_2d(n, target):
    """Smooth tracks, as the render resamples: the linspace positions may
    sit one ulp apart (test_linspace_matches_jnp)."""
    ph = np.linspace(0.0, 3.0, n)
    x = np.sin(ph).astype(np.float32)
    _close(interp.resample_1d(_t(x), target),
           j_interp.resample_1d(jnp.asarray(x), target))
    x2 = np.stack([np.cos(k * ph) for k in range(5)]).astype(np.float32)
    _close(interp.resample_2d(_t(x2), target),
           j_interp.resample_2d(jnp.asarray(x2), target))


@pytest.mark.parametrize("n,left,right", [(10, 3, 4), (5, 12, 17), (1, 4, 2),
                                          (2, 7, 7)])
def test_reflect_pad_matches_numpy(n, left, right):
    x = np.arange(n, dtype=np.float32) * 1.5 - 2.0
    np.testing.assert_array_equal(
        filters.reflect_pad(_t(x), left, right).numpy(),
        np.pad(x, (left, right), mode="reflect"))


@pytest.mark.parametrize("sigma,n", [(0.5, 300), (1.75, 300), (20.0, 3000),
                                     (441.0, 2000), (25.0, 60)])
def test_gaussian_blur1d(sigma, n):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(n).astype(np.float32)
    _close(filters.gaussian_blur1d(_t(x), sigma),
           j_filters.gaussian_blur1d(jnp.asarray(x), sigma))


def test_gaussian_blur_axis0_and_complex():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((513, 40)).astype(np.float32)
    _close(filters.gaussian_blur1d(_t(x), 1.75, axis=0),
           j_filters.gaussian_blur1d(jnp.asarray(x), 1.75, axis=0))
    s = (x + 1j * rng.standard_normal(x.shape)).astype(np.complex64)
    got = filters.gaussian_blur_complex_freq(_t(s), 0.5)
    assert got.dtype == torch.complex64
    _close(got, j_filters.gaussian_blur_complex_freq(jnp.asarray(s), 0.5))


@pytest.mark.parametrize("sigma", [100.0, 60.0])
def test_smooth_mask_downsampled(sigma):
    mask = np.zeros(9000, dtype=np.float32)
    mask[2000:6100] = 1.0
    _close(filters.smooth_mask_downsampled(_t(mask), sigma, 4),
           j_filters.smooth_mask_downsampled(jnp.asarray(mask), sigma, 4))


@pytest.mark.parametrize("n", [5000, 24696, 1])
def test_stft_matches_jax(n):
    rng = np.random.default_rng(4)
    x = rng.standard_normal(n).astype(np.float32)
    got = stft.stft(_t(x), 1024, 256)
    want = np.asarray(j_stft.stft(jnp.asarray(x), 1024, 256))
    assert got.shape == want.shape and got.dtype == torch.complex64
    _close(got, want, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("n", [5000, 24696])
def test_istft_matches_jax(n):
    rng = np.random.default_rng(5)
    t = j_stft.frame_count(n, 1024, 256)
    S = (rng.standard_normal((513, t))
         + 1j * rng.standard_normal((513, t))).astype(np.complex64)
    got = stft.istft(_t(S), 256, length=n)
    want = np.asarray(j_stft.istft(jnp.asarray(S), 256, length=n))
    assert got.shape == want.shape
    _close(got, want, atol=1e-4 * np.abs(want).max())


def _decoded(side, k32, monkeypatch):
    """The knot decode of ``k32`` (48 knots, 90 frames) by the port, by
    goofer_tpu (its matmul dtype and precision pinned to float32 /
    highest) or exactly, in float64 from goofer_tpu's own W."""
    if side == "port":
        return envelope.decode_env_from_knots(torch.as_tensor(k32), SR, 1024,
                                              513).numpy()
    if side == "goofer_tpu":
        from goofer_tpu import config as j_config

        monkeypatch.setattr(j_config, "ENVELOPE_MATMUL_DTYPE", "float32")
        with jax.default_matmul_precision("highest"):
            return np.asarray(j_env.decode_env_from_knots(
                jnp.asarray(k32), SR, 1024, 513))
    w = j_env._decode_matrix(SR, 1024, 48).astype(np.float64)
    return np.exp(w @ k32.astype(np.float64))[:513]


@pytest.mark.parametrize("got_side,want_side", [
    ("port", "float64"), ("goofer_tpu", "float64"), ("port", "goofer_tpu")],
    ids=["port-vs-float64", "goofer_tpu-vs-float64", "port-vs-goofer_tpu"])
def test_decode_env_from_knots(got_side, want_side, monkeypatch):
    """One side of the decode against another; the case's name says
    which side is off.  Each row of W holds two non-zero weights, so a
    float32 evaluation is off by at most 2u sum|w k| in the log envelope
    (two rounded products and one add, u = 2^-24) plus a few ulp of exp:
    the bound below, ~1.5e-6 relative here, doubled between two float32
    sides."""
    rng = np.random.default_rng(6)
    k32 = rng.normal(-4.0, 1.0, (48, 90)).astype(np.float16).astype(
        np.float32)
    w = j_env._decode_matrix(SR, 1024, 48).astype(np.float64)
    u = 2.0 ** -24
    bound = 2 * u * float((np.abs(w) @ np.abs(k32)).max()) + 8 * u
    if want_side != "float64":
        bound *= 2
    got = _decoded(got_side, k32, monkeypatch)
    want = _decoded(want_side, k32, monkeypatch)
    assert got.shape == want.shape == (513, 90)
    rel = np.abs(got / want - 1.0)
    worst = np.unravel_index(np.argmax(rel), rel.shape)
    assert rel.max() <= bound, (
        f"{got_side} vs {want_side}: max relative error {rel.max():.3e} "
        f"at {worst}, {np.mean(rel > bound):.1%} of elements over the "
        f"bound {bound:.3e}")


def _env(seed=7, t=60):
    rng = np.random.default_rng(seed)
    base = np.exp(-np.linspace(0, 5, 513))[:, None]
    return (base * (1.0 + 0.3 * rng.random((513, t)))).astype(np.float32)


@pytest.mark.parametrize("ratio", [1.05, 0.9])
def test_shift_formants_global(ratio):
    env = _env()
    _close(envelope.shift_formants_global(_t(env), ratio, SR),
           j_env.shift_formants_global(jnp.asarray(env),
                                       jnp.float32(ratio), SR))


def test_warp_env_by_formants():
    env = _env(t=40)
    rng = np.random.default_rng(8)
    forms = np.stack([c + 80 * rng.standard_normal(40) for c in
                      (700.0, 1250.0, 2600.0, 3400.0)]).astype(np.float32)
    forms[:, :6] = 0.0                  # invalid anchors in the head
    forms[2, 20] = 30000.0              # one past Nyquist
    shifts = np.array([1.15, 0.9, 1.0, 1.05], dtype=np.float32)
    shifted = forms * shifts[:, None]
    _close(envelope.warp_env_by_formants(_t(env), _t(forms), _t(shifted), SR),
           j_env.warp_env_by_formants(jnp.asarray(env), jnp.asarray(forms),
                                      jnp.asarray(shifted), SR))


@pytest.mark.parametrize("amt", [-0.4, 0.2, 0.0])
def test_env_shape(amt):
    env = _env()
    _close(envelope.env_shape(_t(env), amt),
           j_env.env_shape(jnp.asarray(env), amt))


@pytest.mark.parametrize("target", [30, 60, 95])
def test_match_env_frames(target):
    env = _env()
    _close(envelope.match_env_frames(_t(env), target),
           j_env.match_env_frames(jnp.asarray(env), target))


def test_volume_jitter_vibrato():
    got = jitter.volume_jitter(None, 9000, SR, speed=150.0, strength=0.125,
                               vibrato=True)
    want = j_jitter.volume_jitter(jax.random.PRNGKey(0), 9000, SR,
                                  speed=150.0, strength=0.125, vibrato=True)
    _close(got, want)


def test_subharm_vibrato():
    rng = np.random.default_rng(9)
    f0 = (220.0 + 10 * rng.standard_normal(9000)).astype(np.float32)
    f0[:1000] = 0.0
    got = jitter.subharm_vibrato(_t(f0), SR, 75.0, 3.0, 0.01)
    # the render passes rate/depth as float32 knobs
    want = j_jitter.subharm_vibrato(jnp.asarray(f0), SR, jnp.float32(75.0),
                                    jnp.float32(3.0), 0.01)
    # relative: f0 reaches ~900 Hz, where atol 1e-5 is below one float32
    # ulp, and the 75 Hz vibrato phase reaches ~100 rad, where one ulp of
    # the phase is 8e-6 rad
    _close(got, want, atol=0.0, rtol=1e-5)


@pytest.mark.parametrize("sigma,length", [(7.0, 3000), (73.5, 20000)])
def test_smoothed_unit_noise_same_draw(monkeypatch, sigma, length):
    """The draw differs by design (ops/noise.py vs jax.random); feed
    both the same NumPy draw and compare the deterministic rest."""
    ds = jitter._decimation(sigma)
    m = length if ds == 1 else length // ds + 2
    draw = np.random.default_rng(10).standard_normal(m).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(draw))
    want = j_jitter.smoothed_unit_noise(jax.random.PRNGKey(0), length, sigma)
    got = jitter.smooth_unit_from_draw(_t(draw), length, sigma, ds)
    assert got.shape == (length,)
    _close(got, want)
    keys = torch.as_tensor(noise.stream_keys([0, (0, 1)], 1))[:, 0]
    drawn = jitter.smoothed_unit_noise(keys, length, sigma)
    assert drawn.shape == (2, length)
    # peak-normalized per row, and the rows differ
    np.testing.assert_allclose(drawn.abs().amax(dim=1).numpy(), 1.0,
                               atol=1e-5)
    assert float((drawn[0] - drawn[1]).abs().max()) > 0.1


# ---- the same ops on a leading batch axis, against the JAX op under vmap

B = 3


def _batched_cases():
    rng = np.random.default_rng(20)
    x2 = rng.standard_normal((B, 300)).astype(np.float32)
    x3 = rng.standard_normal((B, 37, 53)).astype(np.float32)
    env = np.stack([_env(seed=30 + i, t=40) for i in range(B)])
    pos_n = rng.uniform(-3.0, 303.0, (B, 101)).astype(np.float32)
    pos_t = rng.uniform(-3.0, 56.0, (B, 61)).astype(np.float32)
    pos_b = rng.uniform(-3.0, 40.0, (B, 45)).astype(np.float32)
    mask = np.zeros((B, 9000), np.float32)
    for i in range(B):
        mask[i, 1500 * i: 4000 + 1500 * i] = 1.0
    sig = rng.standard_normal((B, 5000)).astype(np.float32)
    spec = (rng.standard_normal((B, 513, 21))
            + 1j * rng.standard_normal((B, 513, 21))).astype(np.complex64)
    ratios = np.array([1.05, 0.9, 1.0], np.float32)
    forms = np.stack([c + 80 * rng.standard_normal((B, 40)) for c in
                      (700.0, 1250.0, 2600.0, 3400.0)], 1).astype(np.float32)
    forms[:, :, :6] = 0.0
    forms[1, 2, 20] = 30000.0
    shifts = rng.uniform(0.85, 1.2, (B, 4)).astype(np.float32)
    fry_w = np.clip(rng.uniform(-0.3, 1.2, (B, 40)), 0, 1).astype(np.float32)
    strength = np.array([0.125, 0.02, 0.3], np.float32)
    f0 = (220.0 + 10 * rng.standard_normal((B, 9000))).astype(np.float32)
    f0[:, :1000] = 0.0
    f0[2] = 0.0
    ds = jitter._decimation(73.5)
    draw = rng.standard_normal((B, 20000 // ds + 2)).astype(np.float32)
    smooth = np.stack([np.sin(np.linspace(0.0, 3.0 + i, 300))
                       for i in range(B)]).astype(np.float32)
    jn, vm = jnp.asarray, jax.vmap
    return {
        "gather_lerp_rows": (
            lambda: interp.gather_lerp(_t(x2), _t(pos_n), axis=-1),
            lambda: vm(lambda a, p: j_interp.gather_lerp(a, p, axis=0))(
                jn(x2), jn(pos_n)), ATOL),
        "gather_lerp_frames": (
            lambda: interp.gather_lerp(_t(x3), _t(pos_t), axis=-1),
            lambda: vm(lambda a, p: j_interp.gather_lerp(a, p, axis=-1))(
                jn(x3), jn(pos_t)), ATOL),
        "gather_lerp_bins": (
            lambda: interp.gather_lerp(_t(x3), _t(pos_b), axis=1),
            lambda: vm(lambda a, p: j_interp.gather_lerp(a, p, axis=0))(
                jn(x3), jn(pos_b)), ATOL),
        "gather_lerp_shared_pos": (
            lambda: interp.gather_lerp(_t(x3), _t(pos_t[0]), axis=-1),
            lambda: vm(lambda a: j_interp.gather_lerp(a, jn(pos_t[0]),
                                                      axis=-1))(jn(x3)),
            ATOL),
        "resample_1d": (
            lambda: interp.resample_1d(_t(smooth), 173),
            lambda: vm(lambda a: j_interp.resample_1d(a, 173))(jn(smooth)),
            ATOL),
        "gaussian_blur1d": (
            lambda: filters.gaussian_blur1d(_t(x2), 20.0),
            lambda: vm(lambda a: j_filters.gaussian_blur1d(a, 20.0))(jn(x2)),
            ATOL),
        "gaussian_blur1d_bins": (
            lambda: filters.gaussian_blur1d(_t(env), 1.75, axis=-2),
            lambda: vm(lambda a: j_filters.gaussian_blur1d(a, 1.75, axis=0))(
                jn(env)), ATOL),
        "gaussian_blur_complex_freq": (
            lambda: filters.gaussian_blur_complex_freq(_t(spec), 0.5),
            lambda: vm(lambda a: j_filters.gaussian_blur_complex_freq(
                a, 0.5))(jn(spec)), ATOL),
        "smooth_mask_downsampled": (
            lambda: filters.smooth_mask_downsampled(_t(mask), 100.0, 4),
            lambda: vm(lambda a: j_filters.smooth_mask_downsampled(
                a, 100.0, 4))(jn(mask)), ATOL),
        "stft": (
            lambda: stft.stft(_t(sig), 1024, 256),
            lambda: vm(lambda a: j_stft.stft(a, 1024, 256))(jn(sig)),
            1e-4 * 60.0),
        "istft": (
            lambda: stft.istft(_t(spec), 256, length=5000),
            lambda: vm(lambda a: j_stft.istft(a, 256, length=5000))(jn(spec)),
            1e-4 * 0.2),
        "shift_formants_global": (
            lambda: envelope.shift_formants_global(_t(env), _t(ratios), SR),
            lambda: vm(lambda a, r: j_env.shift_formants_global(a, r, SR))(
                jn(env), jn(ratios)), ATOL),
        "warp_env_by_formants": (
            lambda: envelope.warp_env_by_formants(
                _t(env), _t(forms), _t(forms * shifts[:, :, None]), SR),
            lambda: vm(lambda a, f, g: j_env.warp_env_by_formants(
                a, f, g, SR))(jn(env), jn(forms),
                              jn(forms * shifts[:, :, None])), ATOL),
        "env_shape": (
            lambda: envelope.env_shape(_t(env), 0.2),
            lambda: vm(lambda a: j_env.env_shape(a, 0.2))(jn(env)), ATOL),
        "fry_env_shift": (
            lambda: envelope.fry_env_shift(_t(env), _t(fry_w), 0.92),
            lambda: vm(lambda a, w: j_env.fry_env_shift(a, w, 0.92))(
                jn(env), jn(fry_w)), ATOL),
        "match_env_frames": (
            lambda: envelope.match_env_frames(_t(env), 55),
            lambda: vm(lambda a: j_env.match_env_frames(a, 55))(jn(env)),
            ATOL),
        "volume_jitter_vibrato": (
            lambda: jitter.volume_jitter(None, 9000, SR, speed=150.0,
                                         strength=_t(strength), vibrato=True),
            lambda: vm(lambda s: j_jitter.volume_jitter(
                jax.random.PRNGKey(0), 9000, SR, speed=150.0, strength=s,
                vibrato=True))(jn(strength)), ATOL),
        "subharm_vibrato": (
            lambda: jitter.subharm_vibrato(_t(f0), SR, 75.0, 3.0, 0.01),
            lambda: vm(lambda a: j_jitter.subharm_vibrato(
                a, SR, jnp.float32(75.0), jnp.float32(3.0), 0.01))(jn(f0)),
            -2e-5),
        "smooth_unit_from_draw": (
            lambda: jitter.smooth_unit_from_draw(_t(draw), 20000, 73.5, ds),
            lambda: np.stack([_jax_smooth_unit(d, 20000, 73.5)
                              for d in draw]), ATOL),
    }


def _jax_smooth_unit(draw, length, sigma):
    """goofer_tpu's smoothed_unit_noise on a given draw."""
    real = jax.random.normal
    jax.random.normal = lambda key, shape, dtype=None: jnp.asarray(draw)
    try:
        return np.asarray(j_jitter.smoothed_unit_noise(
            jax.random.PRNGKey(0), length, sigma))
    finally:
        jax.random.normal = real


BATCHED = _batched_cases()


@pytest.mark.parametrize("name", sorted(BATCHED))
def test_batched_op_matches_vmap(name):
    """Each op on (B, ...) rows against the JAX op under jax.vmap, at the
    single-row tolerance; a negative tolerance is relative (the
    subharmonic vibrato, whose f0 reaches ~900 Hz: one ulp of its ~100 rad
    phase on either side, twice test_subharm_vibrato's)."""
    got, want, tol = BATCHED[name]
    got, want = got(), np.asarray(want())
    assert tuple(got.shape) == want.shape
    _close(got, want, atol=max(tol, 0.0), rtol=max(-tol, 0.0))


def _splitmix64(key, i):
    m = (1 << 64) - 1
    z = (key + i * 0x9E3779B97F4A7C15) & m
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
    return z ^ (z >> 31)


def test_noise_bits_are_splitmix64():
    """int64 tensor arithmetic must wrap exactly as SplitMix64's uint64:
    held to Python integers."""
    keys = noise.stream_keys([0, (0, 3), 12345], 2)
    bits = noise.random_bits(torch.as_tensor(keys[:, 1]), 300).numpy()
    for b in range(3):
        ku = int(keys[b, 1]) & ((1 << 64) - 1)
        want = [_splitmix64(ku, i + 1) for i in range(300)]
        assert [int(v) & ((1 << 64) - 1) for v in bits[b]] == want


def test_noise_draws_are_keyed_per_row():
    """A row's draw depends on its key alone (not on its batch), a longer
    draw extends a shorter one, and the draws have the moments of their
    laws (200000 draws: the mean's sigma is 2e-3, 6e-4 for the uniform)."""
    keys = torch.as_tensor(noise.stream_keys([(7, i) for i in range(4)], 1))
    keys = keys[:, 0]
    full = noise.normal(keys, 200000)
    np.testing.assert_array_equal(noise.normal(keys[2:3], 5000)[0].numpy(),
                                  full[2, :5000].numpy())
    u = noise.uniform(keys, 200000)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    np.testing.assert_allclose(u.mean(dim=1).numpy(), 0.5, atol=4e-3)
    np.testing.assert_allclose(full.mean(dim=1).numpy(), 0.0, atol=1.2e-2)
    np.testing.assert_allclose(full.std(dim=1).numpy(), 1.0, atol=1e-2)
    c = np.corrcoef(full.numpy())
    assert np.abs(c - np.eye(4)).max() < 1.5e-2


def test_istft_reads_the_real_parts_of_the_edge_bins():
    """hermitian_edges zeroes the imaginary parts of the DC and Nyquist
    bins and nothing else, and istft's output does not depend on them, as
    NumPy's irfft does not."""
    rng = np.random.default_rng(4)
    S = torch.complex(*(_t(rng.standard_normal((3, 65, 9)).astype(
        np.float32)) for _ in range(2)))
    edged = stft.hermitian_edges(S)
    assert torch.equal(edged.real, S.real)
    assert torch.equal(edged.imag[:, 1:-1], S.imag[:, 1:-1])
    assert not edged.imag[:, [0, -1]].any()
    assert torch.equal(stft.istft(S, 32, 300), stft.istft(edged, 32, 300))
    frames = np.fft.irfft(S.numpy(), n=128, axis=-2)
    _close(torch.fft.irfft(edged, n=128, dim=-2), frames, atol=1e-6)
