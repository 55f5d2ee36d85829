"""Frozen copy of goofer_tpu_torch/ops/interp.py for the benchmark's plain reference:
the plain PyTorch versions of the hand kernels only.

Linear interpolation / resampling on tensors.

Port of goofer_tpu/ops/interp.py (ref interp1d, GOOFER.py:173-239):
positions clamp to the support (edge-hold), and a fractional position
reads two neighbouring rows with ``index_select``; ``linear_interp`` and
``linear_interp_extrap`` are the reference's ``interp1d`` fill and
extrapolate paths over a sorted grid.
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


def _interp(x_new: torch.Tensor, x: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x_new, x, y)``, its formula and order of operations:
    the segment from ``searchsorted(side="right")``, a zero-width segment
    taking its left value, the ends held outside the support."""
    i = torch.clamp(torch.searchsorted(x, x_new, right=True), 1,
                    len(x) - 1)
    df = y[i] - y[i - 1]
    dx = x[i] - x[i - 1]
    delta = x_new - x[i - 1]
    # np.spacing(eps) of x's float type, eps**2 exactly
    dx0 = torch.abs(dx) <= torch.finfo(x.dtype).eps ** 2
    f = torch.where(dx0, y[i - 1],
                    y[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x_new < x[0], y[0], f)
    return torch.where(x_new > x[-1], y[-1], f)


def _as_float(*arrays) -> list[torch.Tensor]:
    """Tensors of one float dtype (float32 unless a tensor brings
    another), on the first tensor's device."""
    ref = next((a for a in arrays if isinstance(a, torch.Tensor)), None)
    dev = ref.device if ref is not None else None
    dtype = ref.dtype if ref is not None and ref.is_floating_point() \
        else torch.float32
    return [torch.as_tensor(a, dtype=dtype, device=dev) for a in arrays]


def linear_interp(x, y, x_new, fill_value: float | None = None
                  ) -> torch.Tensor:
    """np.interp-alike over a sorted 1-D grid ``x``.

    ``fill_value=None`` clamps outside the support (np.interp behaviour);
    a float fills outside the support with that constant
    (ref interp1d numeric fill, GOOFER.py:210-221)."""
    x, y, x_new = _as_float(x, y, x_new)
    out = _interp(x_new, x, y)
    if fill_value is not None:
        inside = (x_new >= x[0]) & (x_new <= x[-1])
        out = torch.where(inside, out, float(fill_value))
    return out


def linear_interp_extrap(x, y, x_new) -> torch.Tensor:
    """Linear interpolation with end-slope linear extrapolation, matching
    the reference's fill_value='extrapolate' path (ref:
    GOOFER.py:204-237).  Requires len(x) >= 2."""
    x, y, x_new = _as_float(x, y, x_new)
    out = _interp(x_new, x, y)
    slope_left = (y[1] - y[0]) / (x[1] - x[0] + 1e-10)
    slope_right = (y[-1] - y[-2]) / (x[-1] - x[-2] + 1e-10)
    out = torch.where(x_new < x[0], y[0] + slope_left * (x_new - x[0]), out)
    return torch.where(x_new > x[-1], y[-1] + slope_right * (x_new - x[-1]),
                       out)
