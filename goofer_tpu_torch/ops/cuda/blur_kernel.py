"""Wrapper of the Hopper Gaussian-blur kernel.

``csrc/gaussian_blur.cu`` blurs a whole batch along one axis in one
launch: reflect-padded rows correlated with symmetric, normalized taps
(it replaces goofer_tpu/ops/filters.py:_conv_valid_lastaxis, non-Pallas
JAX code), built at first use by ops/cuda/_build.py.  The bits of an
output depend on the tap count alone, so a row's result does not depend
on the batch it rides in.

Along the last axis (``blur_rows_kernel``) the taps are cut into
``tap_partition(ntaps)`` partitions, one warp each, whose partials are
added in order; ``rows_geometry`` picks the outputs per lane (``RUNS``)
and the run groups per CTA from the shape, which no output's sum sees.
Along an inner axis (``blur_cols_kernel``) a thread owns a run of
``col_run(...)`` outputs of one column, ``COL_THREADS`` threads per CTA.
The constants mirror the source's.

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
from typing import NamedTuple

import numpy as np
import torch

from goofer_tpu_torch.ops.cuda._build import Kernel, count_launch

WARP = 32
# outputs per lane along the last axis, largest first (odd: a warp's
# windows then start in 32 distinct banks)
RUNS = (15, 7, 3, 1)
# a partition per PART_TAPS taps, at most MAX_PARTS (one warp each),
# each a whole number of TAP_CHUNKs but the last
PART_TAPS = 256
MAX_PARTS = 16
TAP_CHUNK = 16
# warps per CTA the run groups fill up to, when the taps make fewer parts
MIN_WARPS = 4
# the grid the layout aims at: 16 warps on each of the H100's 132 SMs
# (a CTA carries 1 to 16 warps, so CTAs alone do not say it)
MIN_GRID_WARPS = 132 * 16
COL_THREADS = 128
COL_RUN_SHORT = 32
COL_SHORT_TAPS = 17
COL_RUN = 16
# the bin-axis run where the tap count's own leaves fewer threads than
# COL_MIN_THREADS (16 warps on each of 132 SMs), or where fewer than 32
# columns leave a warp's loads strided over several runs (an STFT's
# spectrum stored as (T, bins, 2) floats has 2)
COL_RUN_SMALL = 4
COL_MIN_THREADS = 132 * 16 * 32
MAX_TAPS = 16385
MAX_SIZE = 1 << 30

KERNEL = Kernel(
    "gaussian_blur", "goofer_gaussian_blur",
    [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_longlong] + [ctypes.c_int] * 5
    + [ctypes.c_void_p])


class RowsGeometry(NamedTuple):
    """The rows kernel's layout: ``run`` outputs per lane, ``groups`` run
    groups of 32 lanes and ``parts`` tap partitions of ``part_len`` taps
    per CTA (``threads`` = 32 x groups x parts), ``tile`` outputs per CTA,
    ``tiles`` CTAs per row."""
    run: int
    groups: int
    parts: int
    part_len: int
    tile: int
    tiles: int

    @property
    def threads(self) -> int:
        return WARP * self.groups * self.parts


def tap_partition(ntaps: int) -> tuple[int, int]:
    """(parts, part_len): the rows kernel's split of ``ntaps`` taps, set by
    the tap count alone: partition p sums taps [p part_len, (p + 1)
    part_len) in order, and the partials add in partition order."""
    parts = min(MAX_PARTS, max(1, ntaps // PART_TAPS))
    part_len = -(-ntaps // parts)
    return parts, -(-part_len // TAP_CHUNK) * TAP_CHUNK


def rows_geometry(outer: int, n: int, ntaps: int,
                  run: int | None = None) -> RowsGeometry:
    """The rows kernel's layout for ``outer`` rows of ``n``: the largest
    run of ``RUNS`` whose grid reaches ``MIN_GRID_WARPS``, else the
    smallest (a short row gets a short tile), or the ``run`` given."""
    parts, part_len = tap_partition(ntaps)
    groups = max(1, MIN_WARPS // parts)
    if run is None:
        for run in RUNS:
            ctas = outer * -(-n // (WARP * run * groups))
            if ctas * groups * parts >= MIN_GRID_WARPS:
                break
    if run not in RUNS:
        raise ValueError(f"gaussian_blur: run {run} not one of {RUNS}")
    tile = WARP * run * groups
    return RowsGeometry(run, groups, parts, part_len, tile, -(-n // tile))


def col_run(outer: int, n: int, inner: int, ntaps: int) -> int:
    """Outputs per thread of the bin-axis kernel for ``outer`` slabs of
    ``n`` x ``inner``: the tap count's own (COL_RUN_SHORT for the odd
    counts 3 .. COL_SHORT_TAPS, all of them unrolled; COL_RUN above and
    for the generic instantiation), or COL_RUN_SMALL where that grid
    would not fill the card or a warp would span several runs."""
    run = (COL_RUN_SHORT if 3 <= ntaps <= COL_SHORT_TAPS else COL_RUN)
    if (inner < WARP
            or outer * -(-n // run) * inner < COL_MIN_THREADS):
        return COL_RUN_SMALL
    return run


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
    if x.ndim and max(x.shape) > MAX_SIZE:
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
    return launch_blur(x, taps, axis)


def launch_blur(x: torch.Tensor, taps: np.ndarray, axis: int = -1,
                run: int | None = None) -> torch.Tensor:
    """``gaussian_blur`` on a CUDA tensor; ``run`` forces the outputs per
    lane of the rows kernel (one of ``RUNS``) or per thread of the
    bin-axis kernel (its tap count's or ``COL_RUN_SMALL``), which changes
    no bit of the result."""
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
    if inner > MAX_SIZE:
        raise ValueError(f"gaussian_blur: {inner} columns overflow the "
                         "kernel's int indices")
    if inner == 1:
        geo = rows_geometry(outer, n, len(taps), run)
        layout = (geo.run, geo.groups, geo.parts, geo.part_len)
    else:
        layout = (run or col_run(outer, n, inner, len(taps)), 0, 0, 0)
    out = torch.empty_like(x)
    w = _taps_on(x.device, taps.tobytes())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), outer, n,
                     inner, len(taps), *layout, stream)
    if err != 0:
        raise RuntimeError(f"gaussian_blur kernel launch failed: CUDA error "
                           f"{err}")
    count_launch(gaussian_blur)
    return out


gaussian_blur.launches = 0
