"""Wrapper of the Hopper LF pulse-accumulation kernel.

``csrc/pulse_accumulate.cu`` (which replaces the Pallas TPU kernel
goofer_tpu/ops/pallas/pulse_kernel.py) is built at first use by
ops/cuda/_build.py.

``pulse_accumulate`` takes the kernel's plain PyTorch version
(ops/pulse.py:accumulate_pulses_plain) only for CPU tensors.  For CUDA
tensors it builds and launches the kernel, or raises: a failed build or
launch never falls back.  ``pulse_accumulate.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from goofer_tpu_torch.ops.cuda._build import Kernel

KERNEL = Kernel(
    "pulse_accumulate", "goofer_pulse_accumulate",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_double] * 3
    + [ctypes.c_int, ctypes.c_void_p])


def _check_inputs(row: torch.Tensor, tables) -> None:
    """Device, dtype, shape and contiguity the kernel takes."""
    dev = row.device
    if dev.type != "cuda":
        raise ValueError(f"pulse_accumulate: tensors on {dev}, expected "
                         "CPU (plain version) or CUDA (kernel)")
    if row.dtype != torch.int32 or row.ndim != 2 or not row.is_contiguous():
        raise ValueError("pulse_accumulate: row must be contiguous (B, n) "
                         f"int32, got {row.dtype} {tuple(row.shape)}")
    for t in tables:
        if (t.device != dev or t.dtype != torch.float32 or t.ndim != 2
                or t.shape[0] != row.shape[0] or not t.is_contiguous()):
            raise ValueError(
                "pulse_accumulate: tables must be contiguous (B, M) float32 "
                f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if len({t.shape[1] for t in tables}) != 1:
        raise ValueError("pulse_accumulate: tables differ in length")


def pulse_accumulate(row: torch.Tensor, pos_tab: torch.Tensor,
                     t0_tab: torch.Tensor, t_tab: torch.Tensor,
                     norm_tab: torch.Tensor, Ra: float, Rg: float,
                     Rk: float, guard: bool,
                     max_overlap: int) -> torch.Tensor:
    """Sum of the K = ``max_overlap`` most recent peak-normalized LF pulses
    per sample; (B, n) float32.  See ops/pulse.py for the tables."""
    tables = (pos_tab, t0_tab, t_tab, norm_tab)
    if row.device.type == "cpu" and all(t.device.type == "cpu"
                                        for t in tables):
        from goofer_tpu_torch.ops.pulse import accumulate_pulses_plain

        return accumulate_pulses_plain(row, *tables, Ra, Rg, Rk, guard,
                                       max_overlap)
    _check_inputs(row, tables)
    launch = KERNEL.function()
    batch, n = row.shape
    out = torch.empty((batch, n), dtype=torch.float32, device=row.device)
    with torch.cuda.device(row.device):
        stream = torch.cuda.current_stream(row.device).cuda_stream
        err = launch(
            row.data_ptr(), pos_tab.data_ptr(), t0_tab.data_ptr(),
            t_tab.data_ptr(), norm_tab.data_ptr(), out.data_ptr(),
            batch, n, pos_tab.shape[1], int(max_overlap),
            float(Ra), float(Rg), float(Rk), int(bool(guard)), stream)
    if err != 0:
        raise RuntimeError(f"pulse_accumulate kernel launch failed: CUDA "
                           f"error {err}")
    pulse_accumulate.launches += 1
    return out


pulse_accumulate.launches = 0
