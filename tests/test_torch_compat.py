"""The port's GOOFER-compatible facade vs goofer_tpu's on the CPU:
models/hnm.synthesize with each synthesis option, the compat module's
names and signatures, the three envelope helpers, smooth_noise and
vocal_roughness.  The kernels run as their plain versions here; the card
holds them to those (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances, with their reasons.  Deterministic synthesis (the noise
stems' strengths zeroed, no jitter or roughness): atol 5e-3 x peak and
<= 0.1 dB LSD, the repo's float-accuracy budget (PARITY.md); the two
packages agree to ~4e-7 x peak.  Stochastic stems: <= 1 dB LSD, or
goofer_tpu's own seed-to-seed LSD + 0.5 dB where that is higher (the RNG
streams differ).  Deterministic compat functions: float32 rounding of
two libraries, each case states its bound."""
import pytest

torch = pytest.importorskip("torch")

import ast  # noqa: E402
import inspect  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import goofer_tpu.compat as j_compat  # noqa: E402
from goofer_tpu.models import hnm as j_hnm  # noqa: E402
from goofer_tpu.ops import envelope as j_envelope  # noqa: E402
from goofer_tpu.ops import jitter as j_jitter  # noqa: E402
import goofer_tpu_torch  # noqa: E402
import goofer_tpu_torch.compat as gf  # noqa: E402
from goofer_tpu_torch.io.goofy import load_features  # noqa: E402
from goofer_tpu_torch.models import hnm  # noqa: E402
from goofer_tpu_torch.ops import envelope, jitter  # noqa: E402
from goofer_tpu_torch.ops import noise as rnd  # noqa: E402
from goofer_tpu_torch.utils.metrics import lsd_db  # noqa: E402

SR = 44100
HOP = 256
N = SR // 2
VOICE = Path(__file__).parent / "golden" / "voice"
RNG = np.random.default_rng(11)

# the facade_slice options of chip_smoke.py
FACADE_OPTIONS = dict(
    add_subharm=True, subharm_semitones=(-12, 12), subharm_vibrato=True,
    subharm_f0_jitter=0.3, f0_jitter=True, volume_jitter=True,
    volume_vibrato=True, roughness_on=True, apply_brightness=False)
# each new SynthStatic option alone: (options, deterministic)
OPTIONS = {
    "semitone_list": (dict(add_subharm=True, subharm_semitones=(-12, 12)),
                      True),
    "subharm_vibrato": (dict(add_subharm=True, subharm_vibrato=True,
                             subharm_vibrato_rate=7.0,
                             subharm_vibrato_depth=0.2), True),
    "subharm_f0_jitter": (dict(add_subharm=True, subharm_f0_jitter=0.3),
                          False),
    "volume_vibrato": (dict(volume_jitter=True, volume_vibrato=True,
                            volume_jitter_speed=5.0,
                            volume_jitter_strength_harm=0.3,
                            volume_jitter_strength_breath=0.5), True),
    "brightness_off": (dict(apply_brightness=False), True),
    "keep_below_f0": (dict(cut_subharm_below_f0=False), True),
    "roughness": (dict(roughness_on=True), False),
    "f0_jitter_speed": (dict(f0_jitter=True, f0_jitter_speed=60.0), False),
}
QUIET = dict(uv_strength=0.0, breath_strength=0.0)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("GOOFER_TPU_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def feats():
    """The voice source's first 0.5 s as the facade takes it: the knot
    pack (decoded by synthesize), f0, a voicing mask with an unvoiced
    0.1 s gap, and the formant dict."""
    env, f0, mask, forms, sr, _ = load_features(VOICE / "src_features.goofy")
    t = 1 + N // HOP
    mask = mask[:N].copy()
    mask[int(0.2 * SR):int(0.3 * SR)] = 0.0
    return (dict(env, knot_vals_log=env["knot_vals_log"][:, :t]),
            f0[:N].copy(), mask, {k: np.asarray(v)[:t]
                                  for k, v in forms.items()})


def _both(feats, seed=0, **kw):
    pack, f0, mask, forms = feats
    port = hnm.synthesize(pack, f0, mask, None, SR, formants=forms,
                          seed=seed, **kw)
    ref = j_hnm.synthesize(pack, f0, mask, None, SR, formants=forms,
                           seed=seed, **kw)
    return port, ref


def _deterministic(port, ref):
    for got, want in zip(port[:2], ref[:2]):
        peak = np.abs(want).max()
        assert got.shape == want.shape and peak > 0
        assert np.abs(got - want).max() <= 5e-3 * peak
        assert lsd_db(got, want, SR) <= 0.1


def _stochastic(feats, port, ref, stems, **kw):
    pack, f0, mask, forms = feats
    other = j_hnm.synthesize(pack, f0, mask, None, SR, formants=forms,
                             seed=1, **kw)
    for i in stems:
        assert port[i].shape == ref[i].shape and np.isfinite(port[i]).all()
        floor = lsd_db(other[i], ref[i], SR)
        lsd = lsd_db(port[i], ref[i], SR)
        assert lsd <= max(1.0, floor + 0.5), (i, lsd, floor)


@pytest.mark.parametrize("case", ["plain", "facade_options"])
def test_synthesize_matches_goofer_tpu(feats, case):
    kw = {} if case == "plain" else FACADE_OPTIONS
    port, ref = _both(feats, **kw, **QUIET)
    if case == "plain":
        _deterministic(port, ref)
    else:
        _stochastic(feats, port, ref, (0, 1), **kw, **QUIET)
    port, ref = _both(feats, **kw)
    _stochastic(feats, port, ref, (0, 1, 2, 3), **kw)


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_synthesize_option_alone(feats, name):
    kw, deterministic = OPTIONS[name]
    port, ref = _both(feats, **kw, **QUIET)
    if deterministic:
        _deterministic(port, ref)
    else:
        _stochastic(feats, port, ref, (0, 1), **kw, **QUIET)


def test_synthesize_pitch_shift_and_dense_env(feats):
    """A dense envelope in, pitch and formant shifts on, with the
    facade's pulse-table bounds (f0 doubled: 8-sample spacing)."""
    pack, f0, mask, forms = feats
    env = gf.decode_env_from_knots(pack)
    kw = dict(pitch_shift=2.0, formant_shift=1.1, F1_shift=1.05, **QUIET)
    port = hnm.synthesize(env, f0, mask, None, SR, formants=forms, **kw)
    ref = j_hnm.synthesize(env, f0, mask, None, SR, formants=forms, **kw)
    _deterministic(port, ref)
    # the densest setting: f0 x 2 x (1 + 1.5) jitter, +12 semitones under
    # a depth-0.1 vibrato; every onset spacing of the data fits the tables
    ceil = float(f0.max()) * 2.0 * 2.5
    k, spacing, sub_spacing = hnm.pulse_bounds(
        f0, 2.0, SR, True, 1.5, True, (12.0,), True, 0.1, 0.0)
    assert spacing <= SR / ceil and sub_spacing <= SR / (ceil * 2.0 * 1.1)
    assert k >= np.ceil(0.804 * ceil / min(float(f0[f0 > 0].min()) * 2.0
                                           * 0.25, 160.0))


@pytest.mark.parametrize("span", [None, (0.1, 0.3)])
def test_stretch_all_matches_goofer_tpu(feats, span):
    pack, f0, mask, _ = feats
    env = gf.decode_env_from_knots(pack)
    start, end = span or (None, None)
    got = hnm._stretch_all(torch.as_tensor(env), None, torch.as_tensor(f0),
                           torch.as_tensor(mask), 1.37, start, end, SR, HOP)
    want = j_hnm._stretch_all(jnp.asarray(env), None, jnp.asarray(f0),
                              jnp.asarray(mask), 1.37, start, end, SR, HOP)
    # both packages interpolate at float32 positions, whose ulp at ~20000
    # samples is 2e-3: a value may move by that share of its step
    for g, w, x in zip(got, want, (env, f0, mask)):
        assert g.shape == w.shape
        step = np.abs(np.diff(x, axis=-1)).max()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=2.5e-3 * step)


def _compat_names() -> list:
    """The names goofer_tpu/compat.py defines or re-exports: its
    functions, its module-level assignments and the names it imports
    from goofer_tpu.io.goofy and goofer_tpu.models.hnm."""
    tree = ast.parse(Path(j_compat.__file__).read_text())
    names = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets]
        elif isinstance(node, ast.ImportFrom) and node.module in (
                "goofer_tpu.io.goofy", "goofer_tpu.models.hnm"):
            names += [a.asname or a.name for a in node.names]
    return names


def test_compat_names_and_signatures():
    """Every name of goofer_tpu.compat exists with the same signature;
    the re-exported extract_features may add a trailing ``device``."""
    names = _compat_names()
    assert len(names) > 40
    for name in names:
        assert hasattr(gf, name), name
        want = getattr(j_compat, name)
        got = getattr(gf, name)
        if not callable(want) or isinstance(want, type):
            assert got == want, name
            continue
        params = dict(inspect.signature(got).parameters)
        if name == "extract_features":
            assert params.pop("device").default is None
        assert list(params.values()) == list(
            inspect.signature(want).parameters.values()), name


def test_package_exports():
    import goofer_tpu

    assert goofer_tpu_torch.__all__ == goofer_tpu.__all__
    assert (inspect.signature(goofer_tpu_torch.synthesize)
            == inspect.signature(goofer_tpu.synthesize))


def _voiced(n=8000, hz=180.0):
    t = np.arange(n) / SR
    f0 = (hz * 2 ** (0.3 * np.sin(2 * np.pi * 3.1 * t))).astype(np.float32)
    f0[n // 3: n // 2] = 0.0
    return f0


def _ref_env():
    pack = load_features(VOICE / "src_features.goofy")[0]
    return gf.decode_env_from_knots(dict(
        pack, knot_vals_log=pack["knot_vals_log"][:, :24]))


X = RNG.standard_normal(6000).astype(np.float32)
M2 = RNG.standard_normal((40, 30)).astype(np.float32)
F0 = _voiced()
MASK = (F0 > 0).astype(np.float32)
FORM4 = np.stack([np.full(24, f) for f in (700.0, 1200.0, 2600.0, 3900.0)]
                 ).astype(np.float32) * (1 + 0.05 * RNG.standard_normal(
                     (4, 24))).astype(np.float32)
# name: (call on a compat module, atol relative to the result's peak)
DETERMINISTIC = {
    "get_cached_window": (lambda m: m.get_cached_window(SR, 1024), 0),
    "get_cached_freqs": (lambda m: m.get_cached_freqs(SR, 1024), 0),
    "get_cached_boost": (lambda m: m.get_cached_boost(SR, 1024), 0),
    "get_cached_brightness": (
        lambda m: np.stack(m.get_cached_brightness(SR, 1024)), 0),
    "to_compute": (lambda m: m.to_compute(X.astype(np.float64)), 0),
    "hz_to_mel": (lambda m: m.hz_to_mel(np.linspace(0, 8000, 9)), 1e-7),
    "mel_to_hz": (lambda m: m.mel_to_hz(np.linspace(0, 2800, 9)), 1e-7),
    "make_mel_knots": (lambda m: np.concatenate(m.make_mel_knots(
        SR, 1024, 64)), 0),
    "precompute_interp_matrix": (lambda m: m.precompute_interp_matrix(
        *m.make_mel_knots(SR, 1024, 48)), 1e-6),
    "compress_env_to_knots": (lambda m: m.decode_env_from_knots(
        m.compress_env_to_knots(_ref_env(), SR, 1024)), 1e-4),
    "rms": (lambda m: np.float64(m.rms(X)), 1e-7),
    "interp1d": (lambda m: m.interp1d([0.0, 1.0, 3.0], [0.0, 2.0, 1.0])(
        np.array([-1.0, 0.5, 2.0, 4.0])), 0),
    "gaussian_filter1d": (lambda m: m.gaussian_filter1d(X, 3.0), 1e-5),
    "gaussian_filter": (lambda m: m.gaussian_filter(M2, (2.0, 1.0)), 1e-5),
    "fix_f0_gaps": (lambda m: m.fix_f0_gaps(np.where(
        np.arange(40) % 7 < 2, 0.0, 200.0 + np.arange(40))), 1e-6),
    "stft": (lambda m: m.stft(X, 512, 128), 1e-4),
    "istft": (lambda m: m.istft(m.stft(X, 512, 128), 128, length=6000),
              1e-4),
    "lf_model_pulse": (lambda m: m.lf_model_pulse(1 / 220.0, 0.02, 1.7,
                                                  1.0), 1e-5),
    "pulse_train_numba": (lambda m: m.pulse_train_numba(F0, SR), 1e-4),
    "add_subharms": (lambda m: m.add_subharms(F0, SR, 0.5, -12, MASK),
                     1e-4),
    "add_multiple_subharms": (lambda m: m.add_multiple_subharms(
        F0, SR, (-12, 7), voicing_mask=MASK), 1e-4),
    "apply_subharm_vibrato": (lambda m: m.apply_subharm_vibrato(F0, SR),
                              1e-6),
    "smooth_mask_ds": (lambda m: m.smooth_mask_ds(MASK, 100, 4), 1e-5),
    "create_brightness_curve": (lambda m: m.create_brightness_curve(
        513, SR), 0),
    "create_volume_jitter_vibrato": (lambda m: m.create_volume_jitter(
        6000, SR, 6.0, 0.1, vibrato=True), 1e-6),
    "one_pole_highpass": (lambda m: m.one_pole_highpass(X, SR, 300.0),
                          1e-4),
    # float32 positions: a value may move by an ulp of its position
    # (1e-3 at 8000 samples) times its step, here up to the peak
    "stretch_feature_1d": (lambda m: m.stretch_feature(F0, 1.3), 2.5e-3),
    "stretch_feature_2d": (lambda m: m.stretch_feature(FORM4, 0.7), 1e-5),
    "shift_formants": (lambda m: m.shift_formants(_ref_env(), 1.1, SR),
                       1e-5),
    "match_env_frames": (lambda m: np.concatenate([
        m.match_env_frames(_ref_env(), 30),
        m.match_env_frames(_ref_env(), 20)], axis=1), 0),
    "transpose_formants": (lambda m: np.stack(list(m.transpose_formants(
        {1: FORM4[0], 2: FORM4[1]}, {1: 1.1}).values())), 0),
    "transpose_formants_array": (lambda m: m.transpose_formants_array(
        FORM4, [1.1, 0.9, 1.0, 1.2]), 0),
    "warp_env_by_formants": (lambda m: m.warp_env_by_formants(
        _ref_env(), FORM4, FORM4 * np.array([1.1, 0.9, 1.05, 1.0],
                                            np.float32)[:, None], SR),
        1e-4),
}


def test_lf_model_pulse_smoothed():
    """``smoothing=True`` against the reference's formula in float64
    (ref: GOOFER.py:437-471, 571-583).  goofer_tpu's own compat raises
    here: it writes into the read-only array its gaussian_filter1d
    returns."""
    from tests.oracles import o_gaussian1d

    t0 = int(round(SR / 97.0))
    vals = gf.lf_model_pulse(1 / 97.0)
    want = o_gaussian1d(vals, max(1, t0 // 20))
    want[int(t0 * 0.7):] = 0.0
    want /= np.abs(want).max()
    got = gf.lf_model_pulse(1 / 97.0, smoothing=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", sorted(DETERMINISTIC))
def test_compat_deterministic_matches_goofer_tpu(name):
    call, tol = DETERMINISTIC[name]
    got = np.asarray(call(gf))
    want = np.asarray(call(j_compat))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def test_compat_analysis_matches_goofer_tpu():
    """f0_estimate and extract_formants on a 0.3 s vowel: f0 within
    1e-3 relative on >= 98% of frames, formants within 1 Hz on >= 99%
    (tests/test_torch_analysis.py's budgets)."""
    from tests.test_analysis import _vowel

    y = _vowel(140.0, [700.0, 1220.0, 2600.0], [80.0, 90.0, 120.0],
               dur=0.3)
    got = gf.f0_estimate(y, SR, HOP / SR)
    want = np.asarray(j_compat.f0_estimate(y, SR, HOP / SR))
    assert got.shape == want.shape
    close = np.abs(got - want) <= 1e-3 * np.maximum(want, 1.0)
    assert close.mean() >= 0.98 and (got > 0).mean() > 0.5
    got = gf.extract_formants(y, SR, HOP, target_frames=60)
    want = j_compat.extract_formants(y, SR, HOP, target_frames=60)
    assert sorted(got) == sorted(want)
    g = np.array([got[k] for k in sorted(got)])
    w = np.array([want[k] for k in sorted(want)])
    assert g.shape == w.shape == (5, 60)
    assert (np.abs(g - w) <= 1.0).mean() >= 0.99


# ------------------------------------------------------ envelope helpers

N_BINS = 513


def _smooth_env(t):
    return (np.exp(-np.linspace(0, 5, N_BINS))[:, None]
            * (1 + 0.3 * RNG.random((1, t)))).astype(np.float32)


def test_formant_width_warp():
    env = _smooth_env(4)
    amount = 0.05
    got = envelope.formant_width_warp(torch.as_tensor(env), amount).numpy()
    bins = np.arange(N_BINS, dtype=np.float64)
    center = N_BINS / 2.0
    warped = np.clip((bins - center) * (1 + amount) + center, 0, N_BINS - 1)
    lo = np.floor(warped).astype(int)
    hi = np.minimum(lo + 1, N_BINS - 1)
    frac = warped - lo
    want = (1 - frac)[:, None] * env[lo] + frac[:, None] * env[hi]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(j_envelope.formant_width_warp(
        jnp.asarray(env), amount)), rtol=1e-6, atol=1e-7)
    # per-row amounts of a batch: each row as alone
    rows = envelope.formant_width_warp(
        torch.as_tensor(np.stack([env, env])), torch.tensor([amount, -0.1]))
    np.testing.assert_array_equal(rows[0].numpy(), got)
    np.testing.assert_array_equal(rows[1].numpy(), envelope.formant_width_warp(
        torch.as_tensor(env), -0.1).numpy())


def test_brightness_tilt_mean_normalized():
    env = _smooth_env(3)
    got = envelope.brightness_tilt(torch.as_tensor(env), 1.5, SR).numpy()
    freqs = np.linspace(1e-6, SR * 0.5, N_BINS, dtype=np.float32)
    norm_f = np.clip(freqs / (SR * 0.5), 0.02, 1.0)
    tilt = norm_f ** 0.5
    tilt /= tilt.mean() + 1e-12
    np.testing.assert_allclose(got, env * tilt[:, None], rtol=1e-4)
    np.testing.assert_allclose(got, np.asarray(j_envelope.brightness_tilt(
        jnp.asarray(env), 1.5, SR)), rtol=1e-5)
    rows = envelope.brightness_tilt(torch.as_tensor(np.stack([env, env])),
                                    torch.tensor([1.5, 0.5]), SR)
    np.testing.assert_array_equal(rows[0].numpy(), got)


def test_formant_strength_gain():
    t = 5
    tracks = np.stack([np.full(t, 700.0), np.full(t, 1300.0),
                       np.full(t, 2500.0), np.full(t, 3600.0)]).astype(
                           np.float32)
    tracks[1, 2] = 10.0  # invalid: below 50 Hz -> no gain that frame
    strengths = (0.5, -0.3, 0.0, 0.2)
    gain = envelope.formant_strength_gain(
        (N_BINS, t), torch.as_tensor(tracks), strengths, SR).numpy()
    freqs = np.linspace(0, SR / 2, N_BINS, dtype=np.float32)
    want = np.ones((N_BINS, t), dtype=np.float64)
    sigmas = [100.0, 200.0, 350.0, 500.0]
    for j in range(t):
        for k in range(4):
            f = tracks[k, j]
            if strengths[k] == 0.0 or not 50.0 < f < SR * 0.5:
                continue
            w = np.exp(-0.5 * ((freqs - f) / sigmas[k]) ** 2)
            want[:, j] *= 1.0 + strengths[k] * w
    np.testing.assert_allclose(gain, want, rtol=1e-5, atol=1e-6)
    jgain = np.asarray(j_envelope.formant_strength_gain(
        (N_BINS, t), jnp.asarray(tracks), strengths, SR))
    np.testing.assert_allclose(gain, np.broadcast_to(jgain, gain.shape),
                               rtol=1e-5, atol=1e-6)
    batch = envelope.formant_strength_gain(
        (N_BINS, t), torch.as_tensor(np.stack([tracks, tracks])),
        torch.tensor([strengths, (0.0,) * 4]), SR).numpy()
    np.testing.assert_array_equal(batch[0], gain)
    assert (batch[1] == 1.0).all()


# --------------------------------------------------- noise and roughness

def _mean_psd_db(rows: np.ndarray, nfft: int = 8192) -> np.ndarray:
    p = np.mean(np.abs(np.fft.rfft(rows, nfft, axis=-1)) ** 2, axis=0)
    return 10 * np.log10(p + 1e-30)


def test_smooth_noise_spectrum_matches_goofer_tpu():
    """64 draws each: the mean power spectra agree within 1.5 dB RMS
    over the band within 40 dB of the peak, and the variances within
    20%."""
    n, keys = 8192, torch.arange(64)
    got = jitter.smooth_noise(rnd.fold_in(keys, 0), n, SR, 20.0).numpy()
    want = np.asarray(jax.vmap(lambda k: j_jitter.smooth_noise(
        k, n, SR, 20.0))(jax.random.split(jax.random.PRNGKey(0), 64)))
    pg, pw = _mean_psd_db(got), _mean_psd_db(want)
    band = pw >= pw.max() - 40.0
    assert np.sqrt(np.mean((pg - pw)[band] ** 2)) <= 1.5
    assert abs(got.var() / want.var() - 1.0) <= 0.2
    assert np.array_equal(gf.make_smooth_noise(n, SR, 20.0, seed=3),
                          gf.make_smooth_noise(n, SR, 20.0, seed=3))


def test_vocal_roughness_spectral_parity():
    """On a voiced pulse train with an unvoiced gap: LSD to goofer_tpu's
    <= max(1 dB, goofer_tpu's seed-to-seed + 0.5 dB); through the compat
    name too, and a batch row equals the row alone."""
    f0 = _voiced(12000)
    mask = (f0 > 0).astype(np.float32)
    y = gf.pulse_train_numba(f0, SR)
    got = gf.apply_vocal_roughness(y, f0, mask, SR)
    want = np.asarray(j_compat.apply_vocal_roughness(y, f0, mask, SR))
    other = np.asarray(j_jitter.vocal_roughness(
        jax.random.PRNGKey(1), jnp.asarray(y), jnp.asarray(f0),
        jnp.asarray(mask), SR))
    assert got.shape == want.shape and np.isfinite(got).all()
    assert lsd_db(got, want, SR) <= max(1.0, lsd_db(other, want, SR) + 0.5)
    keys = torch.as_tensor(rnd.stream_keys([0, 1], 1)[:, 0])
    batch = jitter.vocal_roughness(keys, torch.as_tensor(np.stack([y, y])),
                                   torch.as_tensor(f0), torch.as_tensor(mask),
                                   SR, hp_fc=300.0)
    np.testing.assert_allclose(batch[0].numpy(), got, rtol=0, atol=1e-6)
    assert not np.allclose(batch[1].numpy(), got)
