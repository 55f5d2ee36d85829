"""GOOFER.py-compatible module surface.

Port of goofer_tpu/compat.py: ``import goofer_tpu_torch.compat as gf``
exposes the same function names and signatures as the reference engine
module, so code written against ``import GOOFER as gf`` ports by changing
one import.  NumPy in, NumPy out; the work runs on ``config.get_device()``
(CUDA unless $GOOFER_TPU_TORCH_DEVICE names another device) through the
port's ops, and so through its hand kernels on the card: the pulse kernel
(``pulse_train_numba``, ``add_subharms``), the cascade kernel
(``one_pole_highpass``, ``apply_vocal_roughness``) and the three analysis
kernels (``f0_estimate``, ``extract_formants``).  Small host utilities
are NumPy copies.

Each symbol cites its reference definition.  Stochastic functions accept
an optional ``seed`` like the reference; parity is spectral, not
sample-exact (different RNG streams).
"""
from __future__ import annotations

import numpy as np
import torch

from goofer_tpu_torch import config
from goofer_tpu_torch.analysis.formants import track_formants
from goofer_tpu_torch.analysis.pitch import PitchConfig, track_pitch
from goofer_tpu_torch.analysis.pitch import fix_f0_gaps as _fix_f0_gaps_op
from goofer_tpu_torch.io.goofy import (  # noqa: F401  (re-exports)
    formants_to_int_keys,
    load_features,
    pad_trim_to_len,
    save_features,
)
from goofer_tpu_torch.models.hnm import (  # noqa: F401
    extract_features,
    synthesize,
)
from goofer_tpu_torch.ops import envelope as _env
from goofer_tpu_torch.ops import filters as _filters
from goofer_tpu_torch.ops import jitter as _jitter
from goofer_tpu_torch.ops import noise as _noise
from goofer_tpu_torch.ops import pulse as _pulse
from goofer_tpu_torch.ops import scan_iir as _iir
from goofer_tpu_torch.ops import stft as _stft
from goofer_tpu_torch.ops.interp import resample_1d
from goofer_tpu_torch.ops.windows import (
    boost_curve as _boost,
    brightness_curve as _bright,
    brightness_curves as _brights,
    rfft_freqs as _freqs,
    sqrt_hann_window as _win,
)

DSTORAGE = config.STORAGE_DTYPE
DCOMPUTE = config.COMPUTE_DTYPE


def _dev(x, dtype=torch.float32) -> torch.Tensor:
    """A NumPy input on the device."""
    return torch.as_tensor(np.asarray(x), device=config.get_device()).to(
        dtype)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _keys(seed) -> torch.Tensor:
    """(1,) key of a reference-style optional seed (None: 0)."""
    return torch.as_tensor(_noise.stream_keys([0 if seed is None else seed],
                                              1)[:, 0],
                           device=config.get_device())


# -- caches (ref: GOOFER.py:12-46); here pure memoized constructors --------

def get_cached_window(sr, n_fft):
    return _win(n_fft)


def get_cached_freqs(sr, n_fft):
    return _freqs(sr, n_fft)


def get_cached_boost(sr, n_fft):
    return _boost(n_fft)


def get_cached_brightness(sr, n_fft):
    return _brights(sr, n_fft)


def to_compute(x):
    return np.asarray(x, dtype=DCOMPUTE)


# -- mel-knot codec (ref: GOOFER.py:74-168) --------------------------------

hz_to_mel = _env.hz_to_mel
mel_to_hz = _env.mel_to_hz


def make_mel_knots(sr, n_fft, K):
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr).astype(DCOMPUTE)
    return freqs, _env.mel_knot_freqs(sr, n_fft, K)


def precompute_interp_matrix(freqs_full, hz_knots):
    return _env.interp_matrix(np.asarray(freqs_full), np.asarray(hz_knots))


def compress_env_to_knots(env_spec, sr, n_fft, eps=1e-2, K_start=32,
                          K_step=16, K_max=192, smooth_sigma_bins=0.5):
    return _env.compress_env_to_knots(_dev(env_spec), sr, n_fft, eps=eps)


def decode_env_from_knots(env_pack):
    assert env_pack["mode"] == "knots"
    return _np(_env.decode_env_from_knots(
        _dev(env_pack["knot_vals_log"]), int(env_pack["sr"]),
        int(env_pack["n_fft"]), int(env_pack["n_bins"])))


# -- math utils (ref: GOOFER.py:170-285) -----------------------------------

def rms(x):
    return float(np.sqrt(np.mean(np.square(x)) + 1e-12))


def interp1d(x, y, kind="linear", fill_value="extrapolate"):
    """Closure-factory linear interpolator with the reference's
    extrapolation semantics (ref: GOOFER.py:173-239)."""
    if kind != "linear":
        raise ValueError("Only 'linear' interpolation is supported.")
    x = np.asarray(x)
    y = np.asarray(y)
    if len(x) == 0:
        raise ValueError("x cannot be empty")
    if len(x) == 1:
        x0, y0 = x[0], y[0]

        def single(x_new):
            x_new = np.asarray(x_new)
            if fill_value == "extrapolate":
                return np.full_like(x_new, y0, dtype=y.dtype)
            fv = float(fill_value)
            out = np.full_like(x_new, fv)
            out[np.isclose(x_new, x0)] = y0
            return out

        return single

    sl = (y[1] - y[0]) / (x[1] - x[0] + 1e-10)
    sr_ = (y[-1] - y[-2]) / (x[-1] - x[-2] + 1e-10)

    def interp(x_new):
        x_new = np.asarray(x_new)
        out = np.interp(x_new, x, y)
        if fill_value == "extrapolate":
            lo = x_new < x[0]
            hi = x_new > x[-1]
            out = np.where(lo, y[0] + sl * (x_new - x[0]), out)
            out = np.where(hi, y[-1] + sr_ * (x_new - x[-1]), out)
        else:
            fv = float(fill_value)
            inside = (x_new >= x[0]) & (x_new <= x[-1])
            out = np.where(inside, out, fv)
        return out

    return interp


def gaussian_filter1d(input_array, sigma, axis=-1, truncate=4.0):
    arr = np.asarray(input_array)
    if arr.size == 0 or arr.shape[axis] == 0 or sigma <= 0.0:
        return arr.copy()
    return _np(_filters.gaussian_blur1d(_dev(arr), float(sigma), axis=axis,
                                        truncate=truncate))


def gaussian_filter(input_array, sigma):
    arr = np.asarray(input_array)
    if arr.ndim != 2:
        raise ValueError("gaussian_filter expects a 2D array.")
    if arr.size == 0:
        return arr.copy()
    if isinstance(sigma, (list, tuple)):
        s0, s1 = (max(float(s), 0.0) for s in sigma)
    else:
        s0 = s1 = max(float(sigma), 0.0)
    out = arr
    if s0 > 0:
        out = gaussian_filter1d(out, s0, axis=0)
    if s1 > 0:
        out = gaussian_filter1d(out, s1, axis=1)
    return out


# -- analysis (ref: GOOFER.py:341-353, 415-435, 768-792) -------------------

def f0_estimate(y, sr, fr_duration, f0_min=75, f0_max=950):
    """Praat-AC-equivalent pitch track.  Signature differs from the
    reference only in taking (y, sr) instead of a parselmouth Sound."""
    return track_pitch(np.asarray(y, dtype=np.float32), sr, fr_duration,
                       PitchConfig(f0_min=f0_min, f0_max=f0_max))


def fix_f0_gaps(f0_array, max_gap=4):
    return _np(_fix_f0_gaps_op(_dev(f0_array), max_gap))


def extract_formants(y, sr, hop_length, max_formants=5, target_frames=None):
    tracks = track_formants(np.asarray(y, dtype=np.float32), sr,
                            hop_length / sr, max_formants=max_formants,
                            target_frames=target_frames)
    return {i + 1: list(tracks[i]) for i in range(tracks.shape[0])}


# -- STFT (ref: GOOFER.py:355-413) -----------------------------------------

def stft(x, n_fft=2048, hop_length=512, window=None):
    return _np(_stft.stft(_dev(x), n_fft, hop_length, window))


def istft(S, hop_length=512, window=None, length=None):
    return _np(_stft.istft(_dev(S, torch.complex64), hop_length, length,
                           window=window))


# -- glottal source (ref: GOOFER.py:437-554, 571-583) ----------------------

def lf_model_pulse(T, Ra=0.01, Rg=1.47, Rk=0.34, sr=44100, smoothing=False):
    """Single LF pulse sampled over one period (ref: GOOFER.py:437-471)."""
    T0 = int(round(sr * T))
    if T0 <= 3:
        T0 = 3
    u = np.arange(T0) / T0
    vals = _np(_pulse.lf_pulse_value(
        torch.as_tensor(u, dtype=torch.float32),
        torch.tensor(T, dtype=torch.float32), Ra, Rg, Rk, guard=False))
    if smoothing:
        vals = _smooth_arx_pulse(vals, T0)
    peak = np.max(np.abs(vals))
    if peak > 0:
        vals = vals / peak
    return vals.astype(np.float32)


def _smooth_arx_pulse(pulse, T0_samples):
    out = np.asarray(pulse).copy()
    if len(pulse) > 5:
        sigma = max(1, T0_samples // 20)
        out = gaussian_filter1d(out, sigma=sigma)
    closed = int(T0_samples * 0.7)
    if closed < len(out):
        out[closed:] = 0.0
    return out


def pulse_train_numba(f0_interp, sr, Ra=0.02, Rg=1.7, Rk=0.8):
    """Name kept for drop-in compatibility; on the card one launch of the
    pulse kernel (ops/pulse.py), not Numba."""
    return _np(_pulse.pulse_train(_dev(f0_interp), sr, Ra=Ra, Rg=Rg, Rk=Rk))


def add_subharms(f0_interp, sr, subharm_weight=0.5, subharm_semitones=-12,
                 voicing_mask=None):
    f0 = np.asarray(f0_interp, dtype=np.float32)
    if voicing_mask is None:
        voicing_mask = (f0 > 0).astype(np.float32)
    return _np(_pulse.subharm_pulse_train(
        _dev(f0), sr, _dev(voicing_mask), subharm_semitones,
        subharm_weight))


def add_multiple_subharms(f0_interp, sr, semitone_list=(-12, 12),
                          weights=None, voicing_mask=None):
    """Weighted sum of independently-normalized subharmonic layers
    (ref: GOOFER.py:738-746)."""
    semitone_list = list(semitone_list)
    if weights is None:
        weights = [1.0 / len(semitone_list)] * len(semitone_list)
    total = np.zeros_like(np.asarray(f0_interp, dtype=np.float32))
    for semi, w in zip(semitone_list, weights):
        total = total + add_subharms(f0_interp, sr,
                                     voicing_mask=voicing_mask,
                                     subharm_weight=w,
                                     subharm_semitones=semi)
    return total


def apply_subharm_vibrato(f0_interp, sr, vibrato_rate=6.0, vibrato_depth=0.1,
                          vibrato_delay=0.1, seed=None):
    return _np(_jitter.subharm_vibrato(_dev(f0_interp), sr, vibrato_rate,
                                       vibrato_depth, vibrato_delay))


# -- texture (ref: GOOFER.py:556-670, 894-938) -----------------------------

def smooth_mask_ds(mask, sigma=100, ds=4):
    return _np(_filters.smooth_mask_downsampled(_dev(mask), sigma, ds))


def create_brightness_curve(n_bins, sr, start_hz=4000, end_hz=4500,
                            gain_db=6.0):
    return _bright(n_bins, sr, start_hz, end_hz, gain_db)


def create_volume_jitter(length, sr, speed=6.0, strength=0.1, seed=None,
                         vibrato=False):
    # (1, length) drawn from the seed's key; the vibrato draws nothing
    return _np(_jitter.volume_jitter(_keys(seed), length, sr, speed,
                                     strength, vibrato,
                                     config.get_device())).reshape(-1)


def apply_f0_jitter(f0_array, sr, speed=40.0, strength=0.04, seed=None):
    return _np(_jitter.f0_jitter(_keys(seed), len(f0_array), sr, speed,
                                 strength))[0]


def make_smooth_noise(length, sr, smooth_ms=120.0, seed=None):
    return _np(_jitter.smooth_noise(_keys(seed), length, sr, smooth_ms))[0]


def one_pole_highpass(x, sr, fc):
    return _np(_iir.one_pole_highpass(_dev(x), sr, fc))


def apply_vocal_roughness(y, f0_interp, voicing_mask, sr, k_list=(2, 3, 4),
                          h_list=None, alpha=0.6, hp_fc=300.0,
                          noise_amp=0.6, noise_smooth_ms=120.0,
                          alpha_slew_ms=120.0):
    return _np(_jitter.vocal_roughness(
        _keys(0), _dev(y)[None], _dev(f0_interp)[None],
        _dev(voicing_mask)[None], sr, k_list=k_list, h_list=h_list,
        alpha=alpha, hp_fc=hp_fc, noise_amp=noise_amp,
        noise_smooth_ms=noise_smooth_ms, alpha_slew_ms=alpha_slew_ms))[0]


# -- envelope transforms (ref: GOOFER.py:585-875) --------------------------

def stretch_feature(feature, stretch, kind="linear"):
    feature = np.asarray(feature)
    if stretch == 1.0:
        return feature.copy()
    if feature.ndim not in (1, 2):
        raise ValueError("Only 1D or 2D features are supported.")
    target = int(feature.shape[-1] * stretch)
    return _np(resample_1d(_dev(feature, torch.float32), target))


def shift_formants(env, shift_ratio, sr):
    return _np(_env.shift_formants_global(_dev(env), shift_ratio, sr))


def match_env_frames(env, target_frames):
    return _np(_env.match_env_frames(_dev(env), target_frames))


def transpose_formants(formant_tracks, shift_ratios):
    """Dict version (ref: GOOFER.py:794-803)."""
    return {i: np.array(track) * shift_ratios.get(i, 1.0)
            for i, track in formant_tracks.items()}


def transpose_formants_array(formant_array, shift_ratios):
    """(4, T) array version (ref: GOOFER.py:805-812)."""
    ratios = np.asarray(shift_ratios, dtype=np.float64)
    return np.asarray(formant_array) * ratios[:, None]


def warp_env_by_formants(env, orig_formants, shifted_formants, sr):
    return _np(_env.warp_env_by_formants(
        _dev(env), _dev(orig_formants), _dev(shifted_formants), sr))
