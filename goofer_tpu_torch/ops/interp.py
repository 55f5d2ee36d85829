"""Linear interpolation / resampling on tensors.

Port of goofer_tpu/ops/interp.py (ref interp1d, GOOFER.py:173-239):
positions clamp to the support (edge-hold), and a fractional position
reads two neighbouring rows with ``index_select``.
"""
from __future__ import annotations

import torch


def linspace(start: float, stop: float, num: int,
             device: torch.device | str = "cpu") -> torch.Tensor:
    """float32 ``num`` points over [start, stop] by ``jnp.linspace``'s
    formula (start*(1-s) + stop*s, s = i/div, exact endpoints), so
    positions built from it match goofer_tpu's to within one float32 ulp
    (XLA's CPU backend does not round the division correctly; torch's
    ``linspace`` uses another formula and differs by more)."""
    start = torch.tensor(start, dtype=torch.float32, device=device)
    stop = torch.tensor(stop, dtype=torch.float32, device=device)
    if num == 1:
        return start.reshape(1)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / div
    out = start * (1 - step) + stop * step
    return torch.cat([out, stop.reshape(1)])


def gather_lerp(x: torch.Tensor, pos: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """Sample ``x`` at 1-D fractional indices ``pos`` along ``axis``,
    clamping to the edges (edge-hold outside the support)."""
    axis = axis % x.ndim
    n = x.shape[axis]
    pos = torch.clamp(pos, 0.0, n - 1.0)
    lo = torch.clamp(torch.floor(pos).long(), 0, max(n - 2, 0))
    frac = (pos - lo).to(x.dtype)
    a = torch.index_select(x, axis, lo)
    b = torch.index_select(x, axis, torch.clamp(lo + 1, max=n - 1))
    shape = [1] * x.ndim
    shape[axis] = -1
    frac = frac.reshape(shape)
    return a * (1.0 - frac) + b * frac


def resample_1d(x: torch.Tensor, target_len: int) -> torch.Tensor:
    """Linear resample of a 1-D tensor onto ``target_len`` points spanning
    the same [first, last] support (ref stretch_feature,
    GOOFER.py:597-616)."""
    n = x.shape[0]
    if target_len == n:
        return x
    if n == 1:
        return x[:1].expand(target_len).clone()
    pos = linspace(0.0, float(n - 1), target_len, x.device)
    return gather_lerp(x, pos, axis=0)


def resample_2d(x: torch.Tensor, target_len: int) -> torch.Tensor:
    """Linear resample of (n_bins, T) along the frame axis."""
    t = x.shape[1]
    if target_len == t:
        return x
    if t == 1:
        return x.expand(-1, target_len).clone()
    pos = linspace(0.0, float(t - 1), target_len, x.device)
    return gather_lerp(x, pos, axis=1)
