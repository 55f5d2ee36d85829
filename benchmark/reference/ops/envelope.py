"""Frozen copy of goofer_tpu_torch/ops/envelope.py for the benchmark's plain reference:
the plain PyTorch versions of the hand kernels only.

Spectral-envelope codec and envelope-domain transforms.

Port of goofer_tpu/ops/envelope.py: the mel-knot codec, which compresses
a (n_bins, T) envelope to K log-amplitude knots on a mel grid with an
adaptive K search (ref: GOOFER.py:74-168; decode is goofer_tpu's dense
(n_bins, K) @ (K, T) product, here the two-tap lerp each row of that
matrix is, in the search's reconstructions too), the global and
per-formant frequency warps, the width warp, brightness tilt and
formant strength bells, the vocal-fry compression, envelope smoothing /
sharpening and frame-count matching.  The
per-formant warp and the fry compression resample each column with
``torch.gather``; goofer_tpu's banded dense-select form of that gather
exists only to dodge a TPU gather cost and is not ported.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from benchmark.reference.config import COMPUTE_DTYPE
from benchmark.reference.ops.filters import gaussian_blur1d
from benchmark.reference.ops.interp import gather_lerp, linspace, per_row

KNOT_K_START = 32
KNOT_K_STEP = 16
KNOT_K_MAX = 192
KNOT_EPS = 1e-2
KNOT_K_VALUES = tuple(range(KNOT_K_START, KNOT_K_MAX + 1, KNOT_K_STEP))


def hz_to_mel(hz):
    return 2595.0 * np.log10(1.0 + hz / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_knot_freqs(sr: int, n_fft: int, k: int) -> np.ndarray:
    """K knot frequencies equally spaced on the mel scale over [0, sr/2]
    (ref: GOOFER.py:77-82)."""
    mel_min, mel_max = hz_to_mel(0.0), hz_to_mel(sr / 2.0)
    mel_knots = np.linspace(mel_min, mel_max, k, dtype=COMPUTE_DTYPE)
    return mel_to_hz(mel_knots).astype(COMPUTE_DTYPE)


def interp_matrix(freqs_full: np.ndarray, hz_knots: np.ndarray) -> np.ndarray:
    """The dense (n_bins, K) linear-interp matrix W of env = exp(W @
    knots) (ref: GOOFER.py:84-95), from ``interp_taps``."""
    idx, w = interp_taps(np.asarray(freqs_full), np.asarray(hz_knots))
    out = np.zeros((len(freqs_full), len(hz_knots)), dtype=COMPUTE_DTYPE)
    rows = np.arange(len(freqs_full))
    out[rows, idx] = w[:, 0]
    out[rows, idx + 1] = w[:, 1]
    return out


def interp_taps(freqs_full: np.ndarray, hz_knots: np.ndarray):
    """The (n_bins, K) linear-interp matrix W of env = exp(W @ knots)
    (ref: GOOFER.py:84-95) by its two non-zero weights per row: row i
    holds w0[i] at column idx[i] and w1[i] at idx[i] + 1."""
    k = len(hz_knots)
    idx = np.searchsorted(hz_knots, freqs_full, side="right") - 1
    idx = np.clip(idx, 0, k - 2)
    x0 = hz_knots[idx]
    x1 = hz_knots[idx + 1]
    w1 = ((freqs_full - x0) / np.maximum(x1 - x0, 1e-12)).astype(
        COMPUTE_DTYPE)
    w0 = (1.0 - w1).astype(COMPUTE_DTYPE)
    return idx, np.stack([w0, w1], axis=-1)


@functools.lru_cache(maxsize=None)
def _decode_taps(sr: int, n_fft: int, k: int):
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr).astype(COMPUTE_DTYPE)
    return interp_taps(freqs, mel_knot_freqs(sr, n_fft, k))


@functools.lru_cache(maxsize=None)
def _knot_bin_idx(sr: int, n_fft: int, k: int, n_bins: int) -> np.ndarray:
    """The spectrum bin nearest each of the K knot frequencies."""
    bin_resolution = sr / n_fft
    hz_knots = mel_knot_freqs(sr, n_fft, k)
    return np.clip(np.round(hz_knots / bin_resolution).astype(np.int64),
                   0, n_bins - 1)


def decode_log_env_from_knots(knot_vals_log: torch.Tensor, sr: int,
                              n_fft: int, n_bins: int) -> torch.Tensor:
    """W @ knots in float32 for (..., K, T) knots, truncated to n_bins
    rows.  W has two non-zero weights per row, so the product is a lerp
    of two gathered knot rows: two rounded products and one add per
    element, the same on every device and BLAS build."""
    idx, w = _decode_taps(sr, n_fft, knot_vals_log.shape[-2])
    dev = knot_vals_log.device
    idx = torch.as_tensor(idx[:n_bins], device=dev)
    w = torch.as_tensor(w[:n_bins], device=dev)
    knots = knot_vals_log.float()
    return (w[:, :1] * knots.index_select(-2, idx)
            + w[:, 1:] * knots.index_select(-2, idx + 1))


def decode_env_from_knots(knot_vals_log: torch.Tensor, sr: int, n_fft: int,
                          n_bins: int) -> torch.Tensor:
    """exp(W @ knots) in float32 for (..., K, T) knots, truncated to
    n_bins rows (ref: GOOFER.py:149-168); see decode_log_env_from_knots."""
    return torch.exp(decode_log_env_from_knots(knot_vals_log, sr, n_fft,
                                               n_bins))


def knot_errors(env: torch.Tensor, sr: int, n_fft: int,
                smooth_sigma_bins: float = 0.5, check_idx=None):
    """Reconstruction error of a (..., n_bins, T) envelope for every
    candidate K, plus the smoothed log-envelope the knots are read from
    (ref: GOOFER.py:97-123).  Returns (errs (..., len(KNOT_K_VALUES)),
    log_env, KNOT_K_VALUES).

    The error is taken on at most 256 check columns: evenly spread over
    the T frames, or, for a (B, n_bins, T) batch whose rows have fewer
    true frames than T, the (B, C) int64 columns ``check_idx``."""
    env = env.float()
    if smooth_sigma_bins > 0:
        env_s = gaussian_blur1d(env, smooth_sigma_bins, axis=-2)
    else:
        env_s = env
    log_env = torch.log(torch.clamp(env_s, min=1e-8))
    n_bins, t = env.shape[-2:]
    if check_idx is None:
        cols = torch.as_tensor(
            np.linspace(0, t - 1, min(256, t)).astype(np.int64),
            device=env.device)
        env_check = env_s.index_select(-1, cols)
        log_check = log_env.index_select(-1, cols)
    else:
        cols = check_idx[:, None, :].expand(-1, n_bins, -1)
        env_check = torch.gather(env_s, -1, cols)
        log_check = torch.gather(log_env, -1, cols)

    errs = []
    for k in KNOT_K_VALUES:
        bin_idx = torch.as_tensor(_knot_bin_idx(sr, n_fft, k, n_bins),
                                  device=env.device)
        recon = decode_env_from_knots(log_check.index_select(-2, bin_idx),
                                      sr, n_fft, n_bins)
        errs.append((torch.abs(recon - env_check)
                     / (env_check + 1e-8)).amax(dim=(-2, -1)))
    return torch.stack(errs, dim=-1), log_env, KNOT_K_VALUES


def first_k_under(errs, eps: float = KNOT_EPS) -> int:
    """The first candidate K whose error is under ``eps`` (fallback:
    K_max)."""
    for k, e in zip(KNOT_K_VALUES, errs):
        if e < eps:
            return int(k)
    return KNOT_K_VALUES[-1]


def compress_env_to_knots(env, sr: int, n_fft: int, eps: float = KNOT_EPS):
    """Adaptive-K mel-knot compression of one (n_bins, T) envelope,
    returning the reference's dict layout (ref: GOOFER.py:97-147)."""
    env = torch.as_tensor(env, dtype=torch.float32)
    n_bins = env.shape[0]
    errs, log_env, _ = knot_errors(env, sr, n_fft)
    chosen = first_k_under(errs.cpu().numpy(), eps)
    bin_idx = _knot_bin_idx(sr, n_fft, chosen, n_bins)
    return {
        "mode": "knots",
        "knot_vals_log": log_env.cpu().numpy()[bin_idx, :].astype(np.float16),
        "hz_knots": mel_knot_freqs(sr, n_fft, chosen),
        "n_bins": int(n_bins),
        "n_fft": int(n_fft),
        "sr": int(sr),
    }


def gather_lerp_columns(env: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """out[..., b, t] = env[..., pos[..., b, t], t] with linear
    interpolation and edge clamping; ``pos`` is a fractional row index per
    (bin, frame) of a (..., n_bins, T) envelope."""
    n_bins = env.shape[-2]
    pos = torch.clamp(pos, 0.0, n_bins - 1.0)
    lo = torch.clamp(torch.floor(pos).long(), 0, max(n_bins - 2, 0))
    frac = (pos - lo).to(env.dtype)
    a = torch.gather(env, -2, lo)
    b = torch.gather(env, -2, torch.clamp(lo + 1, max=n_bins - 1))
    return a * (1.0 - frac) + b * frac


def shift_formants_global(env: torch.Tensor, shift_ratio, sr: int
                          ) -> torch.Tensor:
    """Global formant shift: resample each frame at freqs/ratio
    (ref: GOOFER.py:618-627).  ``shift_ratio`` is a float for an
    (n_bins, T) envelope or a (B,) tensor, one ratio per row of a
    (B, n_bins, T) batch."""
    n_bins = env.shape[-2]
    freqs = linspace(0.0, sr / 2.0, n_bins, env.device)
    warped = torch.clamp(freqs / per_row(shift_ratio), 0.0, sr / 2.0)
    pos = warped / (sr / 2.0) * (n_bins - 1)
    return gather_lerp(env, pos, axis=-2)


def warp_env_by_formants(env: torch.Tensor, orig_formants: torch.Tensor,
                         shifted_formants: torch.Tensor,
                         sr: int) -> torch.Tensor:
    """Per-formant piecewise-linear frequency warp (ref: GOOFER.py:840-875)
    of a (..., n_bins, T) envelope by (..., 4, T) formant tracks.

    Per frame, anchors map shifted->orig frequency: (0, 0), each valid
    formant pair (f_shifted, f_orig) with f_orig in (50, sr/2) and
    f_shifted > 50, and (sr/2, sr/2).  Invalid anchors are pushed past
    sr/2 so every frame has 6 sorted anchors; each column is then
    resampled at the warped frequencies."""
    n_bins, n_frames = env.shape[-2:]
    nyq = sr / 2.0
    dev = env.device
    freqs = linspace(0.0, nyq, n_bins, dev)

    f_orig = orig_formants.float()                   # (..., 4, T)
    f_shift = shifted_formants.float()
    valid = (f_orig > 50.0) & (f_orig < nyq) & (f_shift > 50.0)

    big = torch.tensor(nyq * 4.0, dtype=torch.float32, device=dev)
    slot_bump = torch.arange(1, 5, dtype=torch.float32, device=dev)[:, None]
    dst_mid = torch.where(valid, f_shift, big + slot_bump)
    src_mid = torch.where(valid, f_orig, big + slot_bump)

    zeros = torch.zeros_like(dst_mid[..., :1, :])
    nyqs = torch.full_like(zeros, nyq)
    dst = torch.cat([zeros, dst_mid, nyqs], dim=-2)  # (..., 6, T)
    src = torch.cat([zeros, src_mid, nyqs], dim=-2)

    order = torch.argsort(dst, dim=-2, stable=True)
    dst = torch.gather(dst, -2, order)
    src = torch.gather(src, -2, order)

    # seg[b, t] = number of anchors <= freqs[b], minus one, clipped
    cmp = dst[..., None, :, :] <= freqs[:, None, None]  # (..., n_bins, 6, T)
    seg = torch.clamp(cmp.sum(dim=-2) - 1, 0, 4)        # (..., n_bins, T)
    x0 = torch.gather(dst, -2, seg)
    x1 = torch.gather(dst, -2, seg + 1)
    y0 = torch.gather(src, -2, seg)
    y1 = torch.gather(src, -2, seg + 1)
    w = (freqs[:, None] - x0) / torch.clamp(x1 - x0, min=1e-10)
    warped_freqs = y0 + w * (y1 - y0)

    pos = warped_freqs / nyq * (n_bins - 1)
    return gather_lerp_columns(env, pos)


def formant_width_warp(env: torch.Tensor, amount) -> torch.Tensor:
    """Stretch the bin axis of (..., n_bins, T) away from its midpoint
    (ref: SillySampler.py:554-574); ``amount`` a float, or (B,) for the
    rows of a (B, n_bins, T) batch."""
    n_bins = env.shape[-2]
    bins = torch.arange(n_bins, dtype=torch.float32, device=env.device)
    center = n_bins / 2.0
    pos = torch.clamp((bins - center) * (1.0 + per_row(amount)) + center,
                      0.0, n_bins - 1.0)
    return gather_lerp(env, pos, axis=-2)


def brightness_tilt(env: torch.Tensor, brightness_env, sr: int
                    ) -> torch.Tensor:
    """Mean-normalized spectral tilt ``norm_f ** alpha`` of (..., n_bins,
    T) (ref: SillySampler.py:503-515); ``brightness_env`` a float, or
    (B,) for the rows of a (B, n_bins, T) batch."""
    n_bins = env.shape[-2]
    freqs = np.linspace(1e-6, sr * 0.5, n_bins, dtype=np.float32)
    norm_f = torch.as_tensor(np.clip(freqs / (sr * 0.5), 0.02, 1.0),
                             device=env.device)
    brightness_env = torch.as_tensor(brightness_env, dtype=torch.float32,
                                     device=env.device)
    alpha = per_row(torch.clamp(brightness_env - 1.0, -0.9, 1.0))
    tilt = norm_f ** alpha
    tilt = tilt / (torch.mean(tilt, dim=-1, keepdim=True) + 1e-12)
    return env * tilt[..., None]


FORMANT_BELL_SIGMAS_HZ = (100.0, 200.0, 350.0, 500.0)


def formant_strength_gain(env_shape_2d, formant_tracks: torch.Tensor,
                          strengths, sr: int) -> torch.Tensor:
    """Per-formant Gaussian gain bells (ref: SillySampler.py:791-833):
    the (..., n_bins, T) multiplicative gain of (..., 4, T) formant
    tracks, ``env_shape_2d`` = (n_bins, T).  ``strengths`` is a 4-tuple,
    or (B, 4) for a (B, 4, T) batch; zero strength is exactly unity
    gain, and frames where a formant is outside (50, sr/2) get none."""
    n_bins = env_shape_2d[0]
    dev = formant_tracks.device
    freqs = linspace(0.0, sr / 2.0, n_bins, dev)[:, None]
    strengths = torch.as_tensor(strengths, dtype=torch.float32, device=dev)
    gain = torch.ones(*formant_tracks.shape[:-2], n_bins,
                      formant_tracks.shape[-1], device=dev)
    for k in range(4):
        fk = formant_tracks[..., k, None, :]
        ok = torch.isfinite(fk) & (fk > 50.0) & (fk < sr * 0.5)
        w = torch.exp(-0.5 * ((freqs - fk) / FORMANT_BELL_SIGMAS_HZ[k]) ** 2)
        gain = gain * (1.0 + strengths[..., k, None, None] * w * ok)
    return gain


def _match_frame_means(orig: torch.Tensor, mod: torch.Tensor) -> torch.Tensor:
    m0 = orig.mean(dim=-2, keepdim=True)
    m1 = mod.mean(dim=-2, keepdim=True)
    return mod * (m0 / (m1 + 1e-12))


def env_shape(env: torch.Tensor, shape_amt: float) -> torch.Tensor:
    """Envelope smoothing (shape_amt < 0) or unsharp-mask sharpening
    (shape_amt > 0) along the bins of (..., n_bins, T), frame-mean
    preserving (ref: SillySampler.py:518-551)."""
    if shape_amt == 0.0 or env.numel() == 0:
        return env
    s = abs(float(shape_amt))
    if shape_amt < 0.0:
        blur = gaussian_blur1d(env, 1.0 + 6.0 * s, axis=-2)
        return torch.clamp(_match_frame_means(env, blur), min=0.0)
    blur = gaussian_blur1d(env, 0.8 + 4.0 * s, axis=-2)
    out = torch.clamp(env + (5.0 * s) * (env - blur), min=0.0)
    return _match_frame_means(env, out)


def fry_env_shift(env: torch.Tensor, fry_weight_frames: torch.Tensor,
                  shift: float = 0.92) -> torch.Tensor:
    """Per-frame envelope compression toward low frequencies under the fry
    mask (ref: SillySampler.py:967-996): scale s = 1 - w (1 - shift),
    each column resampled at bin / s; frames with s == 1 are kept.
    ``env`` (..., n_bins, T), ``fry_weight_frames`` (..., T)."""
    n_bins = env.shape[-2]
    s = (1.0 - fry_weight_frames * (1.0 - shift))[..., None, :]
    bins = torch.arange(n_bins, dtype=torch.float32, device=env.device)
    warped = gather_lerp_columns(env, (bins[:, None] / s).expand_as(env))
    keep = torch.abs(s - 1.0) < 1e-6
    return torch.where(keep, env, warped)


def match_env_frames(env: torch.Tensor, target_frames: int) -> torch.Tensor:
    """Truncate or edge-pad the last (frame) axis (ref: GOOFER.py:629-635)."""
    t = env.shape[-1]
    if t > target_frames:
        return env[..., :target_frames]
    if t < target_frames:
        edge = env[..., -1:].expand(*env.shape[:-1], target_frames - t)
        return torch.cat([env, edge], dim=-1)
    return env
