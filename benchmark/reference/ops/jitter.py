"""Frozen copy of goofer_tpu_torch/ops/jitter.py for the benchmark's plain reference:
the plain PyTorch versions of the hand kernels only.

Stochastic texture modulators: volume/F0 jitter, subharmonic vibrato
and vocal roughness.

Port of goofer_tpu/ops/jitter.py.  Every stochastic op draws with
ops/noise.py from (B,) int64 ``keys``, one key per row and stream, and
returns (B, length): a row's draw depends on its key alone.  The
reference's global unseeded NumPy RNG (ref: GOOFER.py:638-670) makes
parity spectral, never sample-exact.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference.ops import noise as rnd
from benchmark.reference.ops.filters import gaussian_blur1d
from benchmark.reference.ops.interp import linspace, per_row
from benchmark.reference.ops.scan_iir import one_pole_highpass


def _decimation(sigma: float) -> int:
    """Grid decimation for a sigma-sample blur: the blurred process is
    generated on a ds-coarser grid while sigma/ds stays >= 8 (its
    bandwidth sits far below the coarse Nyquist), as goofer_tpu does."""
    ds = 1
    while sigma / (2 * ds) >= 8.0 and ds < 64:
        ds *= 2
    return ds


def smooth_unit_from_draw(c: torch.Tensor, length: int, sigma: float,
                          ds: int) -> torch.Tensor:
    """Blur a white draw ``c`` (..., length//ds + 2 points when ds > 1,
    else ``length``), upsample it linearly by ``ds`` and peak-normalize
    each row: the deterministic half of ``smoothed_unit_noise``."""
    if ds == 1:
        noise = gaussian_blur1d(c, sigma)
    else:
        c = gaussian_blur1d(c, sigma / ds)
        frac = torch.arange(ds, dtype=torch.float32, device=c.device) / ds
        seg = c[..., :-1, None] * (1.0 - frac) + c[..., 1:, None] * frac
        noise = seg.reshape(*c.shape[:-1], -1)[..., :length]
    return noise / torch.amax(torch.abs(noise) + 1e-6, dim=-1, keepdim=True)


def smoothed_unit_noise(keys: torch.Tensor, length: int,
                        sigma: float) -> torch.Tensor:
    """(B, length) Gaussian noise blurred then peak-normalized per row,
    the common core of the jitter generators (ref: GOOFER.py:653-655,
    666-668)."""
    ds = _decimation(sigma)
    m = length if ds == 1 else length // ds + 2
    return smooth_unit_from_draw(rnd.normal(keys, m), length, sigma, ds)


def _fade_in(length: int, fade_samples: int,
             device: torch.device) -> torch.Tensor | None:
    if not 0 < fade_samples < length:
        return None
    return torch.cat([linspace(0.0, 1.0, fade_samples, device),
                      torch.ones(length - fade_samples, device=device)])


def volume_jitter(keys: torch.Tensor | None, length: int, sr: float,
                  speed: float = 6.0, strength=0.1, vibrato: bool = False,
                  device: torch.device | str = "cpu") -> torch.Tensor:
    """Multiplicative volume envelope (ref: GOOFER.py:638-660);
    ``strength`` is a float or one value per row, (B,).

    vibrato=True: zero-phase sinusoid at ``speed`` Hz with a 0.1 s
    fade-in, clipped to [0.5, 1.5]; no random draw, ``keys`` is unused
    and the tensor lies on ``device``.  Otherwise smoothed unit noise per
    key, unclipped, on the keys' device."""
    if vibrato:
        device = torch.device(device)
        t = torch.arange(length, dtype=torch.float32, device=device) / sr
        noise = torch.sin(2.0 * math.pi * speed * t)
        fade = _fade_in(length, int(0.1 * sr), device)
        if fade is not None:
            noise = noise * fade
        return torch.clamp(1.0 + noise * per_row(strength), 0.5, 1.5)
    noise = smoothed_unit_noise(keys, length, sr / (speed * 6.0))
    return 1.0 + noise * per_row(strength)


def f0_jitter(keys: torch.Tensor, length: int, sr: float,
              speed: float = 40.0, strength=0.04) -> torch.Tensor:
    """Multiplicative pitch wobble 1 + noise*strength per key, (B, length)
    (ref: GOOFER.py:662-670)."""
    noise = smoothed_unit_noise(keys, length, sr / (speed * 6.0))
    return 1.0 + noise * per_row(strength)


def subharm_vibrato(f0: torch.Tensor, sr: float, rate=6.0, depth=0.1,
                    delay: float = 0.1) -> torch.Tensor:
    """Sinusoidal vibrato on the subharmonic f0 track (..., n), voiced
    samples only, with a linear fade-in over ``delay`` seconds
    (ref: GOOFER.py:748-766).  ``rate`` and ``depth`` are floats, or (B,)
    for the rows of a (B, n) batch.  The angular rate is a float32
    product, as in goofer_tpu's render where ``rate`` is a float32 knob:
    at 75 Hz a one-ulp difference in it moves the vibrato'd f0 by ~0.01
    Hz."""
    n = f0.shape[-1]
    t = torch.arange(n, dtype=torch.float32, device=f0.device) / sr
    if isinstance(rate, torch.Tensor) and rate.ndim:
        omega = (2.0 * math.pi) * rate.float()[:, None]
        vib = torch.sin(omega.to(f0.device) * t)
    else:
        omega = torch.tensor(2.0 * math.pi, dtype=torch.float32) * rate
        vib = torch.sin(omega.item() * t)
    fade = _fade_in(n, int(delay * sr), f0.device)
    if fade is not None:
        vib = vib * fade
    return torch.where(f0 > 0, f0 * (1.0 + vib * per_row(depth)), f0)


def smooth_noise(keys: torch.Tensor, length: int, sr: float,
                 smooth_ms: float = 120.0) -> torch.Tensor:
    """(B, length) Gaussian-blurred noise per key, not normalized
    (ref: GOOFER.py:894-899)."""
    sigma = max(1.0, (smooth_ms * 1e-3 * sr) / 6.0)
    return gaussian_blur1d(rnd.normal(keys, length), sigma)


def vocal_roughness(keys: torch.Tensor, y: torch.Tensor, f0: torch.Tensor,
                    mask: torch.Tensor, sr: float, k_list=(2, 3, 4),
                    h_list=None, alpha: float = 0.6, hp_fc: float = 300.0,
                    noise_amp: float = 0.6, noise_smooth_ms: float = 120.0,
                    alpha_slew_ms: float = 120.0) -> torch.Tensor:
    """Amplitude-modulate the harmonic rows ``y`` (B, n) with noisy
    sub-multiples of their F0 and mix back only the high-passed
    modulation residue, gated by a slewed voicing-scaled alpha
    (ref: GOOFER.py:901-938).  ``keys`` (B,); the noise of sub-multiple
    ``idx`` draws from sub-stream 1337 + idx of a row's key, as the
    reference seeds it.  The high-pass is one launch of the cascade
    kernel on the card for all rows."""
    y = y.float()
    f0 = f0.float()
    mask = mask.float()
    n = y.shape[-1]

    k_list = list(k_list)
    if h_list is None:
        h_list = [0.45, 0.28, 0.18][: len(k_list)]
        while len(h_list) < len(k_list):
            h_list.append(h_list[-1] * 0.6)
    h_list = list(h_list)[: len(k_list)]

    mod_sum = torch.zeros_like(y)
    for idx, (k, hk) in enumerate(zip(k_list, h_list)):
        nz = smooth_noise(rnd.fold_in(keys, 1337 + idx), n, sr,
                          noise_smooth_ms)
        f_mod = (f0 / float(k)) * (1.0 + noise_amp * nz)
        f_mod = torch.clamp(f_mod, min=0.0) * mask
        # the phase sums in float64, as the reference's NumPy does
        phase = (2.0 * math.pi) * torch.cumsum(f_mod.double(), dim=-1) / sr
        mod_sum = mod_sum + hk * torch.cos(phase).float()

    y_sub_hp = one_pole_highpass(y * mod_sum, sr, hp_fc)
    sigma = max(1.0, (alpha_slew_ms * 1e-3 * sr) / 6.0)
    alpha_slewed = gaussian_blur1d(alpha * mask, sigma)
    return y + alpha_slewed * y_sub_hp
