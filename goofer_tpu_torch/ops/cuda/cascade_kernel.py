"""Wrapper of the Hopper one-pole cascade kernel.

``csrc/one_pole_cascade.cu`` runs a whole time-varying one-pole LP or HP
cascade of order 1-``MAX_ORDER`` in one launch, one thread-block cluster
per row (it replaces goofer_tpu/ops/scan_iir.py's
first_order_recurrence_pos stages, non-Pallas JAX code), and is built at
first use by ops/cuda/_build.py.  ``CLUSTER``, ``THREADS`` and ``RUN``
mirror the source's constants: a row is walked in tiles of ``TILE``
samples, and each thread holds a run of ``RUN`` of them.

``one_pole_cascade`` takes the plain PyTorch version
(ops/scan_iir.py:one_pole_cascade_plain) only for CPU tensors.  For CUDA
tensors it builds and launches the kernel, or raises: a failed build or
launch never falls back.  ``one_pole_cascade.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from goofer_tpu_torch.ops.cuda._build import Kernel, count_launch

BTYPES = ("lowpass", "highpass")
MAX_ORDER = 12
CLUSTER = 8
THREADS = 1024
RUN = 8
TILE = CLUSTER * THREADS * RUN

KERNEL = Kernel(
    "one_pole_cascade", "goofer_one_pole_cascade",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def _check_inputs(x: torch.Tensor, alpha: torch.Tensor) -> None:
    """Device, dtype, shape and contiguity the kernel takes."""
    if x.device.type != "cuda":
        raise ValueError(f"one_pole_cascade: tensors on {x.device}, "
                         "expected CPU (plain version) or CUDA (kernel)")
    for name, t in (("x", x), ("alpha", alpha)):
        if (t.device != x.device or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(
                f"one_pole_cascade: {name} must be contiguous float32 on "
                f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
                f"{'' if t.is_contiguous() else ' (non-contiguous)'}")
    if x.ndim != 2 or alpha.shape not in (x.shape[-1:], x.shape):
        raise ValueError("one_pole_cascade: x must be (B, n) and alpha (n,) "
                         f"or (B, n), got {tuple(x.shape)} and "
                         f"{tuple(alpha.shape)}")
    if x.shape[1] > 2**31 - 1 - TILE:
        raise ValueError(f"one_pole_cascade: rows of {x.shape[1]} samples "
                         "overflow the kernel's int indices")


def one_pole_cascade(x: torch.Tensor, alpha: torch.Tensor, order: int,
                     btype: str) -> torch.Tensor:
    """``order`` one-pole stages of type ``btype`` over the rows of
    ``x`` (B, n) float32 with per-sample coefficients ``alpha``, (n,)
    shared by every row or (B, n).  Returns (B, n) float32; see
    ops/scan_iir.py for the stage recurrences."""
    if btype not in BTYPES:
        raise ValueError(f"unknown btype {btype!r}")
    order = max(1, int(order))
    if x.device.type == "cpu" and alpha.device.type == "cpu":
        from goofer_tpu_torch.ops.scan_iir import one_pole_cascade_plain

        return one_pole_cascade_plain(x, alpha, order, btype)
    if order > MAX_ORDER:
        raise ValueError(f"one_pole_cascade: order {order} > {MAX_ORDER}")
    _check_inputs(x, alpha)
    launch = KERNEL.function()
    batch, n = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), alpha.data_ptr(),
                     n if alpha.ndim == 2 else 0, out.data_ptr(), batch, n,
                     order, BTYPES.index(btype), stream)
    if err != 0:
        raise RuntimeError(f"one_pole_cascade kernel launch failed: CUDA "
                           f"error {err}")
    count_launch(one_pole_cascade)
    return out


one_pole_cascade.launches = 0
