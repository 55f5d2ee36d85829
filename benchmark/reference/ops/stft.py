"""Frozen copy of goofer_tpu_torch/ops/stft.py for the benchmark's plain reference:
the plain PyTorch versions of the hand kernels only.

STFT / iSTFT with sqrt-Hann windows and win^2-normalized overlap-add.

Port of goofer_tpu/ops/stft.py, same framing contract
(ref: GOOFER.py:355-413):

* analysis: center reflect-pad by n_fft//2 (edge-pad for inputs shorter
  than 2 samples), strided frames, sqrt-Hann window, rfft per frame;
  frame count = max(1, 1 + (len(padded) - n_fft) // hop).
* synthesis: irfft per frame, windowed overlap-add normalized by the
  accumulated squared window (skipping samples where it is ~0), center
  trim, then pad/cut to the requested length.  The irfft reads the real
  parts of the DC and Nyquist bins alone, as NumPy's and the reference's
  does (``hermitian_edges``).

Both take a (..., n) batch of signals along the last axis.
``torch.stft``/``torch.istft`` are not used: ``istft`` normalizes the
overlap-add differently.  Framing is ``unfold`` and the overlap-add is
``F.fold`` (col2im), both on cuFFT-sized tensors.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.ops.filters import reflect_pad
from benchmark.reference.ops.windows import sqrt_hann_window


def frame_count(n_samples: int, n_fft: int, hop: int) -> int:
    pad = n_fft // 2
    padded = max(n_samples + 2 * pad, n_fft)
    return max(1, 1 + (padded - n_fft) // hop)


def _window(n_fft: int, window, device) -> torch.Tensor:
    return torch.as_tensor(sqrt_hann_window(n_fft) if window is None
                           else np.asarray(window, dtype=np.float32),
                           device=device)


def stft(x: torch.Tensor, n_fft: int, hop: int,
         window: np.ndarray | None = None) -> torch.Tensor:
    """Complex STFT along the last axis of a (..., n) signal; returns
    (..., n_fft//2 + 1, num_frames) complex64.  ``window`` (n_fft,)
    replaces the sqrt-Hann analysis window."""
    x = x.float()
    n = x.shape[-1]
    pad = n_fft // 2
    if n >= 2:
        xp = reflect_pad(x, pad, pad)
    else:
        xp = x[..., :1].expand(*x.shape[:-1], n + 2 * pad)
    if xp.shape[-1] < n_fft:
        xp = torch.cat([xp, xp[..., -1:].expand(
            *x.shape[:-1], n_fft - xp.shape[-1])], dim=-1)
    num_frames = frame_count(n, n_fft, hop)
    frames = xp.unfold(-1, n_fft, hop)[..., :num_frames, :]   # (..., T, n_fft)
    win = _window(n_fft, window, x.device)
    return torch.fft.rfft(frames * win, dim=-1).transpose(-1, -2)


@functools.lru_cache(maxsize=None)
def _win_sum_sq(n_fft: int, hop: int, num_frames: int,
                expected_len: int) -> np.ndarray:
    """Accumulated window^2 across overlapped frames (host constant)."""
    window = sqrt_hann_window(n_fft).astype(np.float64)
    acc = np.zeros(expected_len, dtype=np.float64)
    w2 = window * window
    for t in range(num_frames):
        acc[t * hop: t * hop + n_fft] += w2
    return acc.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _win_sum_tails(n_fft: int, hop: int) -> np.ndarray:
    """Row k - 1 (k = 1 .. n_fft // hop) holds the accumulated window^2
    past the start of frame k when frame k - 1 is the last of at least k:
    tail[k - 1][r] = sum_{j=1..k} w^2[r + j * hop], r < n_fft - hop."""
    w2 = np.zeros(2 * n_fft, dtype=np.float64)
    w2[:n_fft] = sqrt_hann_window(n_fft).astype(np.float64) ** 2
    r = np.arange(n_fft - hop)
    steps = np.stack([w2[r + j * hop] for j in range(1, n_fft // hop + 1)])
    return np.cumsum(steps, axis=0).astype(np.float32)


def _win_sum_rows(win_sum: torch.Tensor, true_frames: torch.Tensor,
                  n_fft: int, hop: int) -> torch.Tensor:
    """Per-row accumulated window^2 (B, expected_len) when row b's frames
    from ``true_frames[b]`` on are empty: ``win_sum`` (of all the frames)
    before the first empty frame's start, the last true frames' tail
    behind it, zero past their end."""
    tails = torch.as_tensor(_win_sum_tails(n_fft, hop), device=win_sum.device)
    k = true_frames.reshape(-1, 1)
    s = torch.arange(win_sum.shape[0], device=win_sum.device)
    r = s - k * hop
    tail = torch.gather(tails[torch.clamp(k[:, 0], 1, tails.shape[0]) - 1], 1,
                        torch.clamp(r, 0, tails.shape[1] - 1))
    tail = torch.where(r < tails.shape[1], tail, 0.0)
    return torch.where(r < 0, win_sum, tail)


def hermitian_edges(S: torch.Tensor) -> torch.Tensor:
    """(..., n_bins, T) spectra with the imaginary parts of the first and
    last bins (DC and, n_fft being even, Nyquist) zeroed: the spectra a
    real inverse transform can have.  pocketfft (torch and NumPy on the
    CPU, the reference) discards those parts; cuFFT's C2R result for them
    is undefined and changes with the batch size, and the noise stems'
    random phases and the frequency blurs leave them nonzero."""
    parts = torch.view_as_real(S).clone()
    parts[..., 0, :, 1] = 0.0
    parts[..., -1, :, 1] = 0.0
    return torch.view_as_complex(parts)


def istft(S: torch.Tensor, hop: int, length: int | None = None,
          true_frames: torch.Tensor | None = None,
          window: np.ndarray | None = None) -> torch.Tensor:
    """Inverse STFT of (..., n_bins, T) with windowed win^2-normalized
    overlap-add; returns (..., samples).  ``window`` (n_fft,) replaces
    the sqrt-Hann synthesis window; the normalization stays the
    sqrt-Hann window's, as in goofer_tpu.

    ``true_frames`` (B,) int64, for (B, n_bins, T) whose row b is zero
    from frame ``true_frames[b]`` on: each row is normalized by the
    window sum of its true frames alone, as the inverse of its first
    ``true_frames[b]`` frames would be, so the last n_fft samples before
    a bucketed note's true end come out as in its unpadded render."""
    n_fft = (S.shape[-2] - 1) * 2
    num_frames = S.shape[-1]
    batch = S.shape[:-2]
    win = _window(n_fft, window, S.device)
    frames = torch.fft.irfft(hermitian_edges(S), n=n_fft,
                             dim=-2).float() * win[:, None]

    pad = n_fft // 2
    expected_len = n_fft + hop * (num_frames - 1)
    y = F.fold(frames.reshape(-1, n_fft, num_frames),
               output_size=(1, expected_len), kernel_size=(1, n_fft),
               stride=(1, hop)).reshape(*batch, expected_len)

    win_sum = torch.as_tensor(
        _win_sum_sq(n_fft, hop, num_frames, expected_len), device=S.device)
    if true_frames is not None:
        win_sum = _win_sum_rows(win_sum, true_frames, n_fft, hop)
    denom = torch.where(win_sum > 1e-9, win_sum, 1.0)
    y = (y / denom)[..., pad: expected_len - pad]
    if length is not None:
        cur = y.shape[-1]
        if cur < length:
            y = F.pad(y, (0, length - cur))
        else:
            y = y[..., :length]
    return y
