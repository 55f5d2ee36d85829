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


def per_row(v):
    """A per-row parameter, (B,), as a (B, 1) column that broadcasts
    over the rows of a (B, n) batch; floats and 0-d tensors pass through."""
    return v[:, None] if isinstance(v, torch.Tensor) and v.ndim else v


def gather_lerp(x: torch.Tensor, pos: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """Sample ``x`` at fractional indices ``pos`` along ``axis``,
    clamping to the edges (edge-hold outside the support).  ``pos`` (m,)
    is shared by everything in ``x``; ``pos`` (B, m) gives each row of
    the leading batch axis of ``x`` (B, ...) its own positions along a
    later ``axis``."""
    axis = axis % x.ndim
    n = x.shape[axis]
    pos = torch.clamp(pos, 0.0, n - 1.0)
    lo = torch.clamp(torch.floor(pos).long(), 0, max(n - 2, 0))
    hi = torch.clamp(lo + 1, max=n - 1)
    frac = (pos - lo).to(x.dtype)
    shape = [1] * x.ndim
    shape[axis] = -1
    if pos.ndim == 1:
        a = torch.index_select(x, axis, lo)
        b = torch.index_select(x, axis, hi)
    else:
        if axis == 0 or pos.ndim != 2 or pos.shape[0] != x.shape[0]:
            raise ValueError(
                f"gather_lerp: per-row positions {tuple(pos.shape)} need x "
                f"(B, ...) with the same B and axis > 0, got "
                f"{tuple(x.shape)}, axis {axis}")
        shape[0] = pos.shape[0]
        out_shape = list(x.shape)
        out_shape[axis] = pos.shape[1]
        a = torch.gather(x, axis, lo.reshape(shape).expand(out_shape))
        b = torch.gather(x, axis, hi.reshape(shape).expand(out_shape))
    frac = frac.reshape(shape)
    return a * (1.0 - frac) + b * frac


def resample_1d(x: torch.Tensor, target_len: int) -> torch.Tensor:
    """Linear resample of the last axis of a (..., n) tensor onto
    ``target_len`` points spanning the same [first, last] support (ref
    stretch_feature, GOOFER.py:597-616)."""
    n = x.shape[-1]
    if target_len == n:
        return x
    if n == 1:
        return x.expand(*x.shape[:-1], target_len).clone()
    pos = linspace(0.0, float(n - 1), target_len, x.device)
    return gather_lerp(x, pos, axis=-1)


def resample_2d(x: torch.Tensor, target_len: int) -> torch.Tensor:
    """Linear resample of (n_bins, T) along the frame axis."""
    return resample_1d(x, target_len)
