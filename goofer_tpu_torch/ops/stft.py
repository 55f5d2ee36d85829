"""STFT / iSTFT with sqrt-Hann windows and win^2-normalized overlap-add.

Port of goofer_tpu/ops/stft.py, same framing contract
(ref: GOOFER.py:355-413):

* analysis: center reflect-pad by n_fft//2 (edge-pad for inputs shorter
  than 2 samples), strided frames, sqrt-Hann window, rfft per frame;
  frame count = max(1, 1 + (len(padded) - n_fft) // hop).
* synthesis: irfft per frame, windowed overlap-add normalized by the
  accumulated squared window (skipping samples where it is ~0), center
  trim, then pad/cut to the requested length.

``torch.stft``/``torch.istft`` are not used: ``istft`` normalizes the
overlap-add differently.  Framing is ``unfold`` and the overlap-add is
``F.fold`` (col2im), both on cuFFT-sized tensors.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from goofer_tpu_torch.ops.filters import reflect_pad
from goofer_tpu_torch.ops.windows import sqrt_hann_window


def frame_count(n_samples: int, n_fft: int, hop: int) -> int:
    pad = n_fft // 2
    padded = max(n_samples + 2 * pad, n_fft)
    return max(1, 1 + (padded - n_fft) // hop)


def stft(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Complex STFT of a 1-D signal; returns (n_fft//2 + 1, num_frames)
    complex64."""
    x = x.float()
    n = x.shape[0]
    pad = n_fft // 2
    if n >= 2:
        xp = reflect_pad(x, pad, pad)
    else:
        xp = x[:1].expand(n + 2 * pad)
    if xp.shape[0] < n_fft:
        xp = torch.cat([xp, xp[-1:].expand(n_fft - xp.shape[0])])
    num_frames = frame_count(n, n_fft, hop)
    frames = xp.unfold(0, n_fft, hop)[:num_frames].T     # (n_fft, T)
    win = torch.as_tensor(sqrt_hann_window(n_fft), device=x.device)
    return torch.fft.rfft(frames * win[:, None], dim=0)


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


def istft(S: torch.Tensor, hop: int, length: int | None = None
          ) -> torch.Tensor:
    """Inverse STFT with windowed win^2-normalized overlap-add."""
    n_fft = (S.shape[0] - 1) * 2
    num_frames = S.shape[1]
    win = torch.as_tensor(sqrt_hann_window(n_fft), device=S.device)
    frames = torch.fft.irfft(S, n=n_fft, dim=0).float() * win[:, None]

    pad = n_fft // 2
    expected_len = n_fft + hop * (num_frames - 1)
    y = F.fold(frames[None], output_size=(1, expected_len),
               kernel_size=(1, n_fft), stride=(1, hop)).reshape(-1)

    win_sum = _win_sum_sq(n_fft, hop, num_frames, expected_len)
    denom = torch.as_tensor(np.where(win_sum > 1e-9, win_sum, 1.0),
                            device=S.device)
    y = (y / denom)[pad: expected_len - pad]
    if length is not None:
        cur = y.shape[0]
        if cur < length:
            y = F.pad(y, (0, length - cur))
        else:
            y = y[:length]
    return y
