"""Wrapper of the Hopper Burg-LPC kernel.

``csrc/burg_lpc.cu`` runs the whole Burg recursion of a batch of windowed
frames in one launch, one warp per frame with the forward and backward
errors in registers, or in the warp's slice of shared memory past 1152
samples (it replaces goofer_tpu/analysis/formants.py:_burg_coeffs,
non-Pallas JAX code), and is built at first use by ops/cuda/_build.py.
``MAX_WLEN`` mirrors the source's ``kMaxWlen``.

``burg_lpc`` takes the plain PyTorch version
(analysis/formants.py:burg_coeffs_plain) only for CPU tensors.  For CUDA
tensors it builds and launches the kernel, or raises: a failed build or
launch never falls back.  ``burg_lpc.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from goofer_tpu_torch.ops.cuda._build import Kernel, count_launch

MAX_ORDER = 32
MAX_WLEN = 4010

KERNEL = Kernel(
    "burg_lpc", "goofer_burg_lpc",
    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _check_inputs(frames: torch.Tensor, order: int) -> None:
    """Device, dtype, shape and contiguity the kernel takes."""
    if frames.device.type != "cuda":
        raise ValueError(f"burg_lpc: tensor on {frames.device}, expected "
                         "CPU (plain version) or CUDA (kernel)")
    if frames.dtype != torch.float32 or not frames.is_contiguous():
        raise ValueError(
            f"burg_lpc: frames must be contiguous float32, got "
            f"{frames.dtype} {tuple(frames.shape)}"
            f"{'' if frames.is_contiguous() else ' (non-contiguous)'}")
    if frames.ndim != 2 or not 1 <= frames.shape[1] <= MAX_WLEN:
        raise ValueError("burg_lpc: frames must be (rows, wlen) with wlen 1 "
                         f"to {MAX_WLEN}, got {tuple(frames.shape)}")
    if not 1 <= order <= MAX_ORDER:
        raise ValueError(f"burg_lpc: order {order}, the kernel takes 1 to "
                         f"{MAX_ORDER}")
    if frames.shape[0] > 2**31 - 1:
        raise ValueError(f"burg_lpc: {frames.shape[0]} rows overflow the "
                         "kernel's grid")


def burg_lpc(frames: torch.Tensor, order: int) -> torch.Tensor:
    """Burg LPC polynomials of the windowed frames in the rows of
    ``frames`` (rows, wlen) float32.  Returns (rows, order + 1) float32
    with coefficient 0 equal to 1; see
    analysis/formants.py:burg_coeffs_plain."""
    order = int(order)
    if frames.device.type == "cpu":
        from goofer_tpu_torch.analysis.formants import burg_coeffs_plain

        return burg_coeffs_plain(frames, order)
    _check_inputs(frames, order)
    launch = KERNEL.function()
    rows, wlen = frames.shape
    coeffs = torch.empty((rows, order + 1), dtype=torch.float32,
                         device=frames.device)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        err = launch(frames.data_ptr(), coeffs.data_ptr(), rows, wlen, order,
                     stream)
    if err != 0:
        raise RuntimeError(f"burg_lpc kernel launch failed: CUDA error "
                           f"{err}")
    count_launch(burg_lpc)
    return coeffs


burg_lpc.launches = 0
