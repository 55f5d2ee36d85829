"""The benchmark's fixed arithmetic: the H100's peaks, an operation's
least time, the work each op-level call of the hand kernels needs,
percentiles and the union of device intervals.

The peaks and the per-call counts are frozen copies of chip_smoke.py's
(``PEAK_BYTES_S``, ``PEAK_F32_S``, ``bound_ms``, ``_pulse_work``,
``PULSE_OPS_PER_*`` and the cascade's and blur's counts), applied here
to each op-level call the traced window makes.
"""
from __future__ import annotations

import math

# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, float32 FLOP/s
# outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

# operations of the pulse pass: per live (sample, onset row) pair the
# phase division and tests, one sinf or expf + cosf, the normalising
# division and the add; per sample the scan work; per onset its table
# row (reciprocal, rint, the grid peak's two LF evaluations)
PULSE_OPS_PER_PAIR = 30
PULSE_OPS_PER_SAMPLE = 20
PULSE_OPS_PER_ONSET = 60
# one multiply and one add per sample and stage of a one-pole cascade
CASCADE_OPS_PER_STAGE = 3


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the work takes on an H100 SXM: the larger of its
    bytes over the memory peak and its float32 operations over the
    float32 peak."""
    return max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_S)


def pulse_work(batch: int, n: int, gated: bool, pairs: int,
               onsets: int) -> tuple[float, float]:
    """(bytes, operations) of one pulse pass over (batch, n) rows: f0
    (and the gate) read once, the train written once."""
    n_bytes = 4 * (2 + int(gated)) * batch * n
    n_ops = (PULSE_OPS_PER_PAIR * pairs + PULSE_OPS_PER_SAMPLE * batch * n
             + PULSE_OPS_PER_ONSET * onsets)
    return n_bytes, n_ops


def cascade_work(batch: int, n: int, alpha_rows: int,
                 order: int) -> tuple[float, float]:
    """(bytes, operations) of one cascade of ``order`` one-pole stages
    over (batch, n) rows: x read and y written once per row, the
    coefficients once (shared, or one row per row)."""
    return (4 * (2 * batch * n + alpha_rows * n),
            CASCADE_OPS_PER_STAGE * order * batch * n)


def blur_work(outputs: int, ntaps: int) -> tuple[float, float]:
    """(bytes, operations) of one blur: x read and out written once, a
    multiply and an add per tap and output."""
    return 8 * outputs, 2 * ntaps * outputs


def live_pulse_work(tables, max_overlap: int) -> tuple[int, int]:
    """(live (sample, onset row) pairs, onset rows) of a pulse pass on
    its own data, from its onset tables (row, pos_tab, t0_tab, ...):
    pairs j = row - k for k < K inside the table, with 0 <= i - pos[j] <
    T0[j]; rows, the onsets that get one (at most M per row)."""
    import torch

    row, pos_tab, t0_tab = tables[:3]
    n = row.shape[-1]
    t = torch.arange(n, device=row.device, dtype=torch.float32)
    live = 0
    for k in range(max_overlap):
        j = row.long() - k
        ok = (j >= 0) & (j < pos_tab.shape[-1])
        j = j.clamp(0, pos_tab.shape[-1] - 1)
        offs = t - torch.gather(pos_tab, 1, j)
        ok &= (offs >= 0) & (offs < torch.gather(t0_tab, 1, j))
        live += int(ok.sum())
    return live, int(torch.clamp(row[:, -1] + 1,
                                 max=pos_tab.shape[-1]).sum())


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, interpolated
    between order statistics as numpy's default does."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total = 0.0
    end = float("-inf")
    for lo, hi in sorted(intervals):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out = []
    at = lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]
