"""Wrapper of the Hopper LPC root-finder kernel.

``csrc/lpc_roots.cu`` runs every Durand-Kerner iteration of a batch of
monic polynomials in one launch, floor(32 / order) rows per warp and one
root per lane (it replaces goofer_tpu/analysis/formants.py:_poly_roots_dk,
non-Pallas JAX code), and is built at first use by ops/cuda/_build.py.

``lpc_roots`` takes the plain PyTorch version
(analysis/formants.py:poly_roots_dk_plain) only for CPU tensors.  For CUDA
tensors it builds and launches the kernel, or raises: a failed build or
launch never falls back.  ``lpc_roots.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from goofer_tpu_torch.ops.cuda._build import Kernel, count_launch

MAX_ORDER = 32
DK_ITERS = 60

KERNEL = Kernel(
    "lpc_roots", "goofer_lpc_roots",
    [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _check_inputs(coeffs: torch.Tensor) -> None:
    """Device, dtype, shape and contiguity the kernel takes."""
    if coeffs.device.type != "cuda":
        raise ValueError(f"lpc_roots: tensor on {coeffs.device}, expected "
                         "CPU (plain version) or CUDA (kernel)")
    if coeffs.dtype != torch.float32 or not coeffs.is_contiguous():
        raise ValueError(
            f"lpc_roots: coeffs must be contiguous float32, got "
            f"{coeffs.dtype} {tuple(coeffs.shape)}"
            f"{'' if coeffs.is_contiguous() else ' (non-contiguous)'}")
    if coeffs.ndim != 2 or not 2 <= coeffs.shape[1] <= MAX_ORDER + 1:
        raise ValueError("lpc_roots: coeffs must be (rows, order + 1) with "
                         f"order 1 to {MAX_ORDER}, got {tuple(coeffs.shape)}")
    if coeffs.shape[0] > 2**31 - 256:
        raise ValueError(f"lpc_roots: {coeffs.shape[0]} rows overflow the "
                         "kernel's int indices")


def lpc_roots(coeffs: torch.Tensor, iters: int = DK_ITERS) -> torch.Tensor:
    """The complex roots of the monic polynomials in the rows of
    ``coeffs`` (rows, order + 1) float32, leading coefficient first, after
    ``iters`` Durand-Kerner iterations.  Returns (rows, order) complex64;
    see analysis/formants.py:poly_roots_dk_plain."""
    if coeffs.device.type == "cpu":
        from goofer_tpu_torch.analysis.formants import poly_roots_dk_plain

        return poly_roots_dk_plain(coeffs, iters)
    _check_inputs(coeffs)
    launch = KERNEL.function()
    rows, order = coeffs.shape[0], coeffs.shape[1] - 1
    roots = torch.empty((rows, order, 2), dtype=torch.float32,
                        device=coeffs.device)
    with torch.cuda.device(coeffs.device):
        stream = torch.cuda.current_stream(coeffs.device).cuda_stream
        err = launch(coeffs.data_ptr(), roots.data_ptr(), rows, order,
                     int(iters), stream)
    if err != 0:
        raise RuntimeError(f"lpc_roots kernel launch failed: CUDA error "
                           f"{err}")
    count_launch(lpc_roots)
    return torch.view_as_complex(roots)


lpc_roots.launches = 0
