"""Wrapper of the Hopper Gaussian-blur kernel.

``csrc/gaussian_blur.cu`` blurs a whole batch along one axis in one
launch: reflect-padded rows correlated with symmetric, normalized taps,
every output summing its taps in one fixed order, so that a row's result
does not depend on the batch it rides in (it replaces
goofer_tpu/ops/filters.py:_conv_valid_lastaxis, non-Pallas JAX code), and
is built at first use by ops/cuda/_build.py.  ``THREADS``, ``RUN``,
``COL_THREADS``, ``COL_RUN`` and ``MAX_TAPS`` mirror the source's
constants: along the last axis a CTA owns a tile of ``TILE`` outputs,
``RUN`` adjacent ones per thread; along an inner axis a thread owns a
run of ``COL_RUN`` outputs of one column.

``gaussian_blur`` takes the plain PyTorch version
(ops/filters.py:blur_plain, a conv1d of the reflect-padded rows) only for
CPU tensors.  For CUDA tensors it builds and launches the kernel, or
raises: a failed build or launch never falls back.
``gaussian_blur.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from goofer_tpu_torch.ops.cuda._build import Kernel, count_launch

THREADS = 128
RUN = 9
TILE = THREADS * RUN
COL_THREADS = 128
COL_RUN = 16
MAX_TAPS = 16385

KERNEL = Kernel(
    "gaussian_blur", "goofer_gaussian_blur",
    [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _taps_on(device: torch.device, taps: bytes) -> torch.Tensor:
    """The taps as a float32 tensor on ``device``, uploaded once."""
    return torch.tensor(np.frombuffer(taps, dtype=np.float32).copy(),
                        device=device)


def _check_inputs(x: torch.Tensor, ntaps: int) -> None:
    """Device, dtype, contiguity and sizes the kernel takes."""
    if x.device.type != "cuda":
        raise ValueError(f"gaussian_blur: tensor on {x.device}, expected "
                         "CPU (plain version) or CUDA (kernel)")
    if x.dtype != torch.float32:
        raise ValueError(f"gaussian_blur: x must be float32, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not (ntaps % 2 == 1 and 1 <= ntaps <= MAX_TAPS):
        raise ValueError(f"gaussian_blur: {ntaps} taps, the kernel takes an "
                         f"odd count up to {MAX_TAPS}")
    if x.ndim and max(x.shape) > 2**31 - 1 - MAX_TAPS:
        raise ValueError(f"gaussian_blur: shape {tuple(x.shape)} overflows "
                         "the kernel's int indices")


def gaussian_blur(x: torch.Tensor, taps: np.ndarray,
                  axis: int = -1) -> torch.Tensor:
    """Blur ``x`` float32 along ``axis`` with the odd, symmetric float32
    ``taps`` over numpy-style reflect padding of (len(taps) - 1) / 2
    samples a side; the shape is kept.  See ops/filters.py:blur_plain."""
    if x.device.type == "cpu":
        from goofer_tpu_torch.ops.filters import blur_plain

        return blur_plain(x, taps, axis)
    taps = np.ascontiguousarray(taps, dtype=np.float32)
    _check_inputs(x, len(taps))
    launch = KERNEL.function()
    if x.numel() == 0:
        return torch.empty_like(x)
    axis = axis % x.ndim
    x = x.contiguous()
    n = x.shape[axis]
    outer = math.prod(x.shape[:axis])
    inner = math.prod(x.shape[axis + 1:])
    out = torch.empty_like(x)
    w = _taps_on(x.device, taps.tobytes())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), outer, n,
                     inner, len(taps), stream)
    if err != 0:
        raise RuntimeError(f"gaussian_blur kernel launch failed: CUDA error "
                           f"{err}")
    count_launch(gaussian_blur)
    return out


gaussian_blur.launches = 0
