"""Frozen copy of goofer_tpu_torch/ops/scan_iir.py for the benchmark's plain reference:
the plain PyTorch versions of the hand kernels only.

Time-varying one-pole filter cascades.

Port of goofer_tpu/ops/scan_iir.py.  The reference runs these as
sequential Numba loops (one_pole_highpass: GOOFER.py:877-892,
_dynamic_butter_filter_core: SillySampler.py:118-174).  A stage is the
affine recurrence y[i] = a[i] * y[i-1] + b[i] with y[-1] = 0:

    LP: y[i] = y[i-1] + alpha[i] * (x[i] - y[i-1])       a = 1 - alpha
    HP: y[i] = alpha[i] * (y[i-1] + x[i] - x[i-1])      a = alpha,
        x[-1] := x[0]

and an order-N cascade re-applies the stage N times, each stage reading
the previous one's output.  On the card the whole cascade is one launch
of csrc/one_pole_cascade.cu (ops/cuda/cascade_kernel.py); on the CPU it
is ``one_pole_cascade_plain``, a Hillis-Steele doubling scan over the
affine maps (a, b) in the linear domain.  goofer_tpu's log-domain
32-sample blocks exist to keep exp inside float32 on the TPU and are not
ported.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.ops.interp import per_row, resample_1d


def _affine_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve y[i] = a[i] * y[i-1] + b[i], y[-1] = 0, along the last axis
    by log2(n) doubling steps: after the step of offset d, (a[i], b[i])
    is the composed map of the 2d samples ending at i."""
    n = a.shape[-1]
    d = 1
    while d < n:
        b = torch.cat([b[..., :d], a[..., d:] * b[..., :-d] + b[..., d:]], -1)
        a = torch.cat([a[..., :d], a[..., d:] * a[..., :-d]], -1)
        d *= 2
    return b


def one_pole_cascade_plain(x: torch.Tensor, alpha: torch.Tensor, order: int,
                           btype: str) -> torch.Tensor:
    """The cascade kernel's plain version: ``order`` stages over the rows
    of ``x`` (B, n) float32, coefficients ``alpha`` (n,) or (B, n)."""
    y = x.float()
    alpha = alpha.float()
    for _ in range(max(1, int(order))):
        if btype == "lowpass":
            y = _affine_scan((1.0 - alpha).expand_as(y), alpha * y)
        elif btype == "highpass":
            dx = torch.diff(y, dim=-1, prepend=y[..., :1])
            y = _affine_scan(alpha.expand_as(y), alpha * dx)
        else:
            raise ValueError(f"unknown btype {btype!r}")
    return y


def cascade(x: torch.Tensor, alpha: torch.Tensor, order: int,
            btype: str) -> torch.Tensor:
    """``one_pole_cascade`` on a (n,) or (..., n) signal: one launch for
    all rows.  alpha (n,) is shared by every row; alpha of ``x``'s shape
    gives each row its own coefficients."""
    n = x.shape[-1]
    rows = x.reshape(-1, n).float().contiguous()
    alpha = alpha.float()
    if alpha.ndim > 1:
        alpha = alpha.expand(x.shape).reshape(-1, n)
    return one_pole_cascade_plain(rows, alpha.contiguous(), order,
                                  btype).reshape(x.shape)


def one_pole_highpass(x: torch.Tensor, sr: float, fc: float) -> torch.Tensor:
    """Static one-pole highpass along the last axis of (..., n): y[i] = a (y[i-1] + x[i] - x[i-1]) with
    x[-1] = 0, a = rc / (rc + 1/sr), rc = 1 / (2 pi fc)
    (ref: GOOFER.py:877-892).

    The cascade's HP stage starts from x[-1] := x[0] instead; the two
    differ by the free response to the first sample, x[0] a^(i+1)."""
    x = x.float()
    if fc <= 0:
        return torch.zeros_like(x)
    rc = 1.0 / (2.0 * math.pi * fc)
    a = torch.tensor(rc / (rc + 1.0 / sr), dtype=torch.float32,
                     device=x.device)
    y = cascade(x, a.expand(x.shape[-1]), 1, "highpass")
    steps = torch.arange(1, x.shape[-1] + 1, dtype=torch.float32,
                         device=x.device)
    return y + x[..., :1] * a ** steps


def butter_alpha(f0: torch.Tensor, n: int, sr: float, cutoff_factor,
                 btype: str) -> torch.Tensor:
    """dynamic_butter_filter's stage coefficients, (n,) for an f0 track
    (m,) or (B, n) for a batch (B, m), for the cutoff fc: f0 *
    cutoff_factor where f0 > 0, else the raw cutoff_factor (in Hz);
    floors 60 Hz (LP) / 20 Hz (HP); ceiling 0.45 sr.  ``cutoff_factor``
    is a float or one value per row, (B,).  f0 is resampled to n samples
    and each row gets an edge-padded 5-tap moving average when any of
    its samples is voiced.  LP alpha = 2 pi fc / (2 pi fc + sr),
    HP alpha = sr / (2 pi fc + sr)."""
    if btype not in ("lowpass", "highpass"):
        raise ValueError(f"unknown btype {btype!r}")
    f0 = f0.float()
    if f0.shape[-1] != n:
        f0 = resample_1d(f0, n)
    cutoff_factor = per_row(cutoff_factor)
    padded = F.pad(f0.reshape(-1, 1, n), (2, 2), mode="replicate")
    taps = torch.full((1, 1, 5), 1.0 / 5.0, dtype=torch.float32,
                      device=f0.device)
    smoothed = F.conv1d(padded, taps).reshape(f0.shape)
    f0_s = torch.where(torch.any(f0 > 0, dim=-1, keepdim=True), smoothed, f0)
    fc = torch.where(f0_s > 0.0, f0_s * cutoff_factor,
                     torch.zeros_like(f0_s) + cutoff_factor)
    lowpass = btype == "lowpass"
    fc = torch.clamp(fc, 60.0 if lowpass else 20.0, 0.45 * sr)
    w = 2.0 * math.pi * fc
    return w / (w + sr) if lowpass else sr / (w + sr)


def dynamic_butter_filter(signal: torch.Tensor, f0: torch.Tensor, sr: float,
                          cutoff_factor, order: int = 4,
                          btype: str = "lowpass") -> torch.Tensor:
    """F0-tracking cascaded one-pole filter (ref: SillySampler.py:95-115)
    on a (n,) signal, on a (B, n) stack sharing one f0 track (m,), or on
    (B, n) rows each with its own f0 row (B, m) and, optionally, its own
    ``cutoff_factor`` (B,); the coefficients are butter_alpha's."""
    x = signal.float()
    n = x.shape[-1]
    if n == 0:
        return x
    return cascade(x, butter_alpha(f0, n, sr, cutoff_factor, btype), order,
                   btype)
