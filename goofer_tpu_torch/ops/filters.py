"""Gaussian smoothing as a static-kernel convolution.

Port of goofer_tpu/ops/filters.py, matching the reference's
``gaussian_filter1d`` (ref: GOOFER.py:241-261): radius
``int(truncate * sigma + 0.5)``, normalized taps, reflect padding,
'valid' convolution.  Every blur is one ``conv1d`` of the reflect-padded
rows; the JAX package's conv-vs-FFT routing existed for XLA-TPU compile
times and has no counterpart here.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """Normalized Gaussian taps; radius = int(truncate*sigma + 0.5)."""
    radius = int(truncate * float(sigma) + 0.5)
    t = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (t / float(sigma)) ** 2)
    k /= k.sum()
    return k.astype(np.float32)


def reflect_pad(x: torch.Tensor, left: int, right: int,
                dim: int = -1) -> torch.Tensor:
    """``np.pad(mode="reflect")`` along ``dim`` for any pad width.

    ``F.pad(mode="reflect")`` needs a batch dimension and pads shorter
    than the input; long Gaussian windows over short tracks exceed that,
    so the padded index is the period-2(n-1) reflection of the source
    index (numpy's repeated reflection)."""
    n = x.shape[dim]
    idx = torch.arange(-left, n + right, device=x.device)
    if n == 1:
        idx = torch.zeros_like(idx)
    else:
        period = 2 * (n - 1)
        idx = torch.remainder(idx, period)
        idx = torch.where(idx >= n, period - idx, idx)
    return torch.index_select(x, dim, idx)


def gaussian_blur1d(x: torch.Tensor, sigma: float, axis: int = -1,
                    truncate: float = 4.0) -> torch.Tensor:
    """Gaussian blur along ``axis`` with reflect padding (host sigma)."""
    if sigma is None or float(sigma) <= 0.0:
        return x
    kernel = gaussian_kernel1d(float(sigma), truncate)
    radius = (kernel.shape[0] - 1) // 2
    if radius <= 0:
        return x
    moved = torch.movedim(x, axis, -1)
    shape = moved.shape
    flat = moved.reshape(-1, 1, shape[-1])
    padded = reflect_pad(flat, radius, radius)
    w = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    # symmetric taps: correlation == convolution
    out = F.conv1d(padded, w.reshape(1, 1, -1))
    return torch.movedim(out.reshape(shape), -1, axis)


def gaussian_blur_complex_freq(S: torch.Tensor, sigma: float) -> torch.Tensor:
    """Frequency-axis blur of a complex spectrogram, real and imaginary
    parts separately (ref: GOOFER.py:1143 applies its real filter to
    complex data).  complex64 in, complex64 out."""
    re = gaussian_blur1d(S.real.contiguous(), sigma, axis=0)
    im = gaussian_blur1d(S.imag.contiguous(), sigma, axis=0)
    return torch.complex(re, im)


def smooth_mask_downsampled(mask: torch.Tensor, sigma: float = 100.0,
                            ds: int = 4) -> torch.Tensor:
    """Soft voiced/unvoiced crossfade (ref: GOOFER.py:556-569): decimate
    by ``ds``, blur with sigma/ds (floored at 1), resample back to the
    original length over a shared [0, 1] axis."""
    from goofer_tpu_torch.ops.interp import resample_1d

    n = mask.shape[0]
    short = mask[::ds].float() if ds > 1 else mask.float()
    sig_short = max(1.0, float(sigma) / max(1, ds))
    short_s = gaussian_blur1d(short, sig_short)
    if ds > 1:
        return resample_1d(short_s, n)
    return short_s
