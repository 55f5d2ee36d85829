"""Spectral-envelope decode and envelope-domain transforms.

Port of the render-path half of goofer_tpu/ops/envelope.py: the mel-knot
decode (a dense (n_bins, K) @ (K, T) product, ref: GOOFER.py:149-168),
the global and per-formant frequency warps, envelope smoothing /
sharpening and frame-count matching.  The per-formant warp resamples
each column with ``torch.gather``; goofer_tpu's banded dense-select form
of that gather exists only to dodge a TPU gather cost and is not ported.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from goofer_tpu_torch.config import COMPUTE_DTYPE
from goofer_tpu_torch.ops.filters import gaussian_blur1d
from goofer_tpu_torch.ops.interp import gather_lerp, linspace


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
    """(n_bins, K) linear-interp matrix; env = exp(W @ knots)
    (ref: GOOFER.py:84-95)."""
    n = len(freqs_full)
    k = len(hz_knots)
    idx = np.searchsorted(hz_knots, freqs_full, side="right") - 1
    idx = np.clip(idx, 0, k - 2)
    x0 = hz_knots[idx]
    x1 = hz_knots[idx + 1]
    w1 = (freqs_full - x0) / np.maximum(x1 - x0, 1e-12)
    w0 = 1.0 - w1
    w = np.zeros((n, k), dtype=COMPUTE_DTYPE)
    rows = np.arange(n)
    w[rows, idx] = w0
    w[rows, idx + 1] = w1
    return w


@functools.lru_cache(maxsize=None)
def _decode_matrix(sr: int, n_fft: int, k: int) -> np.ndarray:
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr).astype(COMPUTE_DTYPE)
    return interp_matrix(freqs, mel_knot_freqs(sr, n_fft, k))


def decode_env_from_knots(knot_vals_log: torch.Tensor, sr: int, n_fft: int,
                          n_bins: int) -> torch.Tensor:
    """exp(W @ knots) in float32, truncated to n_bins rows
    (ref: GOOFER.py:149-168)."""
    k = knot_vals_log.shape[0]
    w = torch.as_tensor(_decode_matrix(sr, n_fft, k),
                        device=knot_vals_log.device)
    env = torch.exp(torch.matmul(w, knot_vals_log.float()))
    return env[:n_bins]


def gather_lerp_columns(env: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """out[b, t] = env[pos[b, t], t] with linear interpolation and edge
    clamping; ``pos`` is a fractional row index per (bin, frame)."""
    n_bins = env.shape[0]
    pos = torch.clamp(pos, 0.0, n_bins - 1.0)
    lo = torch.clamp(torch.floor(pos).long(), 0, max(n_bins - 2, 0))
    frac = (pos - lo).to(env.dtype)
    a = torch.gather(env, 0, lo)
    b = torch.gather(env, 0, torch.clamp(lo + 1, max=n_bins - 1))
    return a * (1.0 - frac) + b * frac


def shift_formants_global(env: torch.Tensor, shift_ratio: float,
                          sr: int) -> torch.Tensor:
    """Global formant shift: resample each frame at freqs/ratio
    (ref: GOOFER.py:618-627)."""
    n_bins = env.shape[0]
    freqs = linspace(0.0, sr / 2.0, n_bins, env.device)
    warped = torch.clamp(freqs / shift_ratio, 0.0, sr / 2.0)
    pos = warped / (sr / 2.0) * (n_bins - 1)
    return gather_lerp(env, pos, axis=0)


def warp_env_by_formants(env: torch.Tensor, orig_formants: torch.Tensor,
                         shifted_formants: torch.Tensor,
                         sr: int) -> torch.Tensor:
    """Per-formant piecewise-linear frequency warp (ref: GOOFER.py:840-875).

    Per frame, anchors map shifted->orig frequency: (0, 0), each valid
    formant pair (f_shifted, f_orig) with f_orig in (50, sr/2) and
    f_shifted > 50, and (sr/2, sr/2).  Invalid anchors are pushed past
    sr/2 so every frame has 6 sorted anchors; each column is then
    resampled at the warped frequencies."""
    n_bins, n_frames = env.shape
    nyq = sr / 2.0
    dev = env.device
    freqs = linspace(0.0, nyq, n_bins, dev)

    f_orig = orig_formants.float()                   # (4, T)
    f_shift = shifted_formants.float()
    valid = (f_orig > 50.0) & (f_orig < nyq) & (f_shift > 50.0)

    big = torch.tensor(nyq * 4.0, dtype=torch.float32, device=dev)
    slot_bump = torch.arange(1, 5, dtype=torch.float32, device=dev)[:, None]
    dst_mid = torch.where(valid, f_shift, big + slot_bump)
    src_mid = torch.where(valid, f_orig, big + slot_bump)

    zeros = torch.zeros(1, n_frames, dtype=torch.float32, device=dev)
    nyqs = torch.full((1, n_frames), nyq, dtype=torch.float32, device=dev)
    dst = torch.cat([zeros, dst_mid, nyqs], dim=0)   # (6, T)
    src = torch.cat([zeros, src_mid, nyqs], dim=0)

    order = torch.argsort(dst, dim=0, stable=True)
    dst = torch.gather(dst, 0, order)
    src = torch.gather(src, 0, order)

    # seg[b, t] = number of anchors <= freqs[b], minus one, clipped
    cmp = dst[None, :, :] <= freqs[:, None, None]    # (n_bins, 6, T)
    seg = torch.clamp(cmp.sum(dim=1) - 1, 0, 4)       # (n_bins, T)
    x0 = torch.gather(dst, 0, seg)
    x1 = torch.gather(dst, 0, seg + 1)
    y0 = torch.gather(src, 0, seg)
    y1 = torch.gather(src, 0, seg + 1)
    w = (freqs[:, None] - x0) / torch.clamp(x1 - x0, min=1e-10)
    warped_freqs = y0 + w * (y1 - y0)

    pos = warped_freqs / nyq * (n_bins - 1)
    return gather_lerp_columns(env, pos)


def _match_frame_means(orig: torch.Tensor, mod: torch.Tensor) -> torch.Tensor:
    m0 = orig.mean(dim=0, keepdim=True)
    m1 = mod.mean(dim=0, keepdim=True)
    return mod * (m0 / (m1 + 1e-12))


def env_shape(env: torch.Tensor, shape_amt: float) -> torch.Tensor:
    """Envelope smoothing (shape_amt < 0) or unsharp-mask sharpening
    (shape_amt > 0), frame-mean preserving (ref: SillySampler.py:518-551)."""
    if shape_amt == 0.0 or env.numel() == 0:
        return env
    s = abs(float(shape_amt))
    if shape_amt < 0.0:
        blur = gaussian_blur1d(env, 1.0 + 6.0 * s, axis=0)
        return torch.clamp(_match_frame_means(env, blur), min=0.0)
    blur = gaussian_blur1d(env, 0.8 + 4.0 * s, axis=0)
    out = torch.clamp(env + (5.0 * s) * (env - blur), min=0.0)
    return _match_frame_means(env, out)


def match_env_frames(env: torch.Tensor, target_frames: int) -> torch.Tensor:
    """Truncate or edge-pad the frame axis (ref: GOOFER.py:629-635)."""
    t = env.shape[1]
    if t > target_frames:
        return env[:, :target_frames]
    if t < target_frames:
        return F.pad(env[None], (0, target_frames - t), mode="replicate")[0]
    return env
