"""Wrapper of the Hopper LF pulse-pass kernel.

``csrc/pulse_accumulate.cu`` (which replaces the Pallas TPU kernel
goofer_tpu/ops/pallas/pulse_kernel.py and the onset-table build around
it) takes a (B, n) f0 row and writes its (B, n) pulse train in one
launch, one thread-block cluster per row, and is built at first use by
ops/cuda/_build.py.  ``CLUSTER``, ``THREADS`` and ``RUN`` mirror the
source's constants: a row is walked in tiles of at most ``TILE`` samples
(``tile_geometry``), each thread holds a run of ``RUN`` of them, and a CTA
stages up to ``WINDOW`` table rows in shared memory.

``pulse_accumulate`` takes the plain PyTorch version
(ops/pulse.py:pulse_pass_plain) only for CPU tensors.  For CUDA tensors
it builds and launches the kernel, or raises: a failed build or launch
never falls back.  ``pulse_accumulate.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from goofer_tpu_torch.ops.cuda._build import Kernel, count_launch

CLUSTER = 8
THREADS = 1024
RUN = 8
TILE = CLUSTER * THREADS * RUN
WINDOW = (THREADS * RUN + THREADS * RUN // 32) // 4

KERNEL = Kernel(
    "pulse_accumulate", "goofer_pulse_accumulate",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_double] * 6
    + [ctypes.c_int, ctypes.c_void_p])


def tile_geometry(n: int, cluster: int = CLUSTER, span: int = 32 * RUN,
                  seg_max: int = THREADS * RUN) -> tuple[int, int]:
    """(tile, segment) lengths of the kernel's walk over an n-sample row:
    the fewest tiles of at most ``cluster * seg_max`` samples, each split
    evenly over the cluster's CTAs in whole warps' spans of ``span``."""
    tiles = max(1, -(-n // (cluster * seg_max)))
    per_tile = -(-n // tiles)
    seg = -(-per_tile // (cluster * span)) * span
    return cluster * seg, seg


def table_rows(n: int, min_spacing: int) -> int:
    """M, the onset-table rows of an n-sample row: onsets past M - 1
    count but never sound (ops/pulse.py:_compact_onset_tables)."""
    return n // min_spacing + 2


def _check_inputs(f0: torch.Tensor, gate: torch.Tensor | None) -> None:
    """Device, dtype, shape and contiguity the kernel takes."""
    if f0.device.type != "cuda":
        raise ValueError(f"pulse_accumulate: tensors on {f0.device}, "
                         "expected CPU (plain version) or CUDA (kernel)")
    for name, t in (("f0", f0), ("gate", gate)):
        if t is None:
            continue
        if (t.device != f0.device or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(
                f"pulse_accumulate: {name} must be contiguous float32 on "
                f"{f0.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
                f"{'' if t.is_contiguous() else ' (non-contiguous)'}")
    if f0.ndim != 2 or (gate is not None and gate.shape != f0.shape):
        raise ValueError("pulse_accumulate: f0 and gate must be (B, n), got "
                         f"{tuple(f0.shape)} and "
                         f"{None if gate is None else tuple(gate.shape)}")
    if f0.shape[1] > 2**31 - 1 - TILE:
        raise ValueError(f"pulse_accumulate: rows of {f0.shape[1]} samples "
                         "overflow the kernel's int indices")


def pulse_accumulate(f0: torch.Tensor, gate: torch.Tensor | None,
                     sr: float, scale: float, fallback_f0: float,
                     Ra: float, Rg: float, Rk: float, guard: bool,
                     max_overlap: int, min_spacing: int) -> torch.Tensor:
    """One pulse pass over the rows of ``f0`` (B, n) float32: the
    ``scale``d f0's float64 phase, its onsets and onset tables, and the
    sum of the K = ``max_overlap`` most recent peak-normalized LF pulses
    per sample.  ``gate`` None is the main pass; a (B, n) gate makes it the
    gated subharmonic pass.  Returns (B, n) float32; see
    ops/pulse.py:pulse_pass_plain."""
    args = (sr, scale, fallback_f0, Ra, Rg, Rk, guard, max_overlap,
            min_spacing)
    if f0.device.type == "cpu" and (gate is None or gate.device.type == "cpu"):
        from goofer_tpu_torch.ops.pulse import pulse_pass_plain

        return pulse_pass_plain(f0, gate, *args)
    _check_inputs(f0, gate)
    launch = KERNEL.function()
    batch, n = f0.shape
    m = table_rows(n, min_spacing)
    table = torch.empty((batch, m, 4), dtype=torch.float32, device=f0.device)
    out = torch.empty_like(f0)
    with torch.cuda.device(f0.device):
        stream = torch.cuda.current_stream(f0.device).cuda_stream
        err = launch(
            f0.data_ptr(), None if gate is None else gate.data_ptr(),
            table.data_ptr(), out.data_ptr(), batch, n, m, int(max_overlap),
            float(sr), float(scale), float(fallback_f0), float(Ra),
            float(Rg), float(Rk), int(bool(guard)), stream)
    if err != 0:
        raise RuntimeError(f"pulse_accumulate kernel launch failed: CUDA "
                           f"error {err}")
    count_launch(pulse_accumulate)
    return out


pulse_accumulate.launches = 0
