"""Gaussian smoothing as a static-kernel convolution.

Port of goofer_tpu/ops/filters.py, matching the reference's
``gaussian_filter1d`` (ref: GOOFER.py:241-261): radius
``int(truncate * sigma + 0.5)``, normalized taps, reflect padding,
'valid' convolution.  Every blur is one launch of the Hopper kernel
``ops/cuda/blur_kernel.py`` (``csrc/gaussian_blur.cu``), a direct sum
whose rows do not depend on the batch; ``blur_plain`` below, one
``conv1d`` of the reflect-padded rows, is its plain PyTorch version,
which the wrapper runs only for CPU tensors.  The JAX package's
conv-vs-FFT routing existed for XLA-TPU compile times and has no
counterpart here.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from goofer_tpu_torch.ops.cuda.blur_kernel import gaussian_blur


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


def blur_plain(x: torch.Tensor, kernel: np.ndarray,
               axis: int = -1) -> torch.Tensor:
    """``x`` along ``axis`` reflect-padded by (len(kernel) - 1) / 2 a side
    and correlated with the odd, symmetric ``kernel``: the plain version
    of the blur kernel."""
    radius = (kernel.shape[0] - 1) // 2
    moved = torch.movedim(x, axis, -1)
    shape = moved.shape
    flat = moved.reshape(-1, 1, shape[-1])
    padded = reflect_pad(flat, radius, radius)
    w = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    # symmetric taps: correlation == convolution
    out = F.conv1d(padded, w.reshape(1, 1, -1))
    return torch.movedim(out.reshape(shape), -1, axis)


def gaussian_blur1d(x: torch.Tensor, sigma: float, axis: int = -1,
                    truncate: float = 4.0) -> torch.Tensor:
    """Gaussian blur along ``axis`` with reflect padding (host sigma)."""
    if sigma is None or float(sigma) <= 0.0:
        return x
    kernel = gaussian_kernel1d(float(sigma), truncate)
    if kernel.shape[0] <= 1:
        return x
    return gaussian_blur(x, kernel, axis)


def gaussian_blur_freq(env: torch.Tensor, sigma: float) -> torch.Tensor:
    """Blur a (..., n_bins, T) spectrogram-like array along the frequency
    axis."""
    return gaussian_blur1d(env, sigma, axis=-2)


def fir_decimate(x: torch.Tensor, kernel: np.ndarray,
                 step: int) -> torch.Tensor:
    """Every ``step``-th sample of the 'same' convolution of (B, n) rows
    with a symmetric odd-length FIR ``kernel`` over the edge-padded rows:
    the anti-aliased decimation of the formant tracker.  Returns
    (B, ceil(n / step)).

    One strided ``conv1d`` in full float32 (config pins TF32 off), which
    computes only the kept samples; goofer_tpu filters every sample
    through a power-of-two FFT (its fft_conv_valid, shaped by XLA-TPU
    compile times) and slices.  Both sit outside any kernel."""
    pad = (len(kernel) - 1) // 2
    padded = torch.cat([x[:, :1].expand(-1, pad), x,
                        x[:, -1:].expand(-1, pad)], dim=1)
    w = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    # symmetric taps: correlation == convolution
    return F.conv1d(padded[:, None], w.reshape(1, 1, -1), stride=step)[:, 0]


def gaussian_blur_complex_freq(S: torch.Tensor, sigma: float) -> torch.Tensor:
    """Frequency-axis blur of a complex spectrogram, real and imaginary
    parts separately (ref: GOOFER.py:1143 applies its real filter to
    complex data).  (..., n_bins, T) complex64 in and out."""
    re = gaussian_blur1d(S.real.contiguous(), sigma, axis=-2)
    im = gaussian_blur1d(S.imag.contiguous(), sigma, axis=-2)
    return torch.complex(re, im)


def smooth_mask_downsampled(mask: torch.Tensor, sigma: float = 100.0,
                            ds: int = 4) -> torch.Tensor:
    """Soft voiced/unvoiced crossfade (ref: GOOFER.py:556-569): decimate
    by ``ds``, blur with sigma/ds (floored at 1), resample back to the
    original length over a shared [0, 1] axis.  Rows of a (..., n) mask
    are smoothed independently."""
    from goofer_tpu_torch.ops.interp import resample_1d

    n = mask.shape[-1]
    short = mask[..., ::ds].float() if ds > 1 else mask.float()
    sig_short = max(1.0, float(sigma) / max(1, ds))
    short_s = gaussian_blur1d(short, sig_short)
    if ds > 1:
        return resample_1d(short_s, n)
    return short_s
