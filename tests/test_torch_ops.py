"""goofer_tpu_torch ops vs their goofer_tpu counterparts on the CPU.

The same seeded NumPy inputs go through the JAX function and its port.
Tolerances: interpolation, filters, envelope transforms and the
deterministic jitter forms are float32 elementwise chains (atol 1e-5);
the STFT/iSTFT sum in another FFT order (1e-4 x peak); the knot decode
is a float32 matrix product followed by exp (rtol 1e-5)."""
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
from goofer_tpu_torch.ops import envelope, filters, interp, jitter, stft  # noqa: E402

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


def test_decode_env_from_knots():
    rng = np.random.default_rng(6)
    knots = rng.normal(-4.0, 1.0, (48, 90)).astype(np.float16)
    got = envelope.decode_env_from_knots(
        torch.as_tensor(knots.astype(np.float32)), SR, 1024, 513)
    want = j_env.decode_env_from_knots(
        jnp.asarray(knots, dtype=jnp.float32), SR, 1024, 513)
    _close(got, want, atol=0.0, rtol=1e-5)


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
    """The draw differs by design (torch.Generator vs jax.random); feed
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
    gen = torch.Generator().manual_seed(0)
    drawn = jitter.smoothed_unit_noise(gen, length, sigma, torch.device("cpu"))
    assert drawn.shape == (length,) and float(drawn.abs().max()) <= 1.0
