"""Stochastic texture modulators: volume/F0 jitter and subharmonic vibrato.

Port of goofer_tpu/ops/jitter.py.  Every stochastic op draws from an
explicit ``torch.Generator`` (one per stream, seeded by the caller); the
reference's global unseeded NumPy RNG (ref: GOOFER.py:638-670) makes
parity spectral, never sample-exact.  ``vocal_roughness`` is not ported
yet: the note render never enables it and it needs the one-pole
highpass of ops/scan_iir.py.
"""
from __future__ import annotations

import math

import torch

from goofer_tpu_torch.ops.filters import gaussian_blur1d
from goofer_tpu_torch.ops.interp import linspace


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
    """Blur a white draw ``c`` (length//ds + 2 points when ds > 1, else
    ``length``), upsample it linearly by ``ds`` and peak-normalize — the
    deterministic half of ``smoothed_unit_noise``."""
    if ds == 1:
        noise = gaussian_blur1d(c, sigma)
        return noise / torch.max(torch.abs(noise) + 1e-6)
    c = gaussian_blur1d(c, sigma / ds)
    frac = torch.arange(ds, dtype=torch.float32, device=c.device) / ds
    seg = c[:-1, None] * (1.0 - frac) + c[1:, None] * frac
    noise = seg.reshape(-1)[:length]
    return noise / torch.max(torch.abs(noise) + 1e-6)


def smoothed_unit_noise(gen: torch.Generator, length: int, sigma: float,
                        device: torch.device) -> torch.Tensor:
    """Gaussian noise blurred then peak-normalized, the common core of the
    jitter generators (ref: GOOFER.py:653-655, 666-668)."""
    ds = _decimation(sigma)
    m = length if ds == 1 else length // ds + 2
    c = torch.randn(m, generator=gen, dtype=torch.float32, device=device)
    return smooth_unit_from_draw(c, length, sigma, ds)


def _fade_in(length: int, fade_samples: int,
             device: torch.device) -> torch.Tensor | None:
    if not 0 < fade_samples < length:
        return None
    return torch.cat([linspace(0.0, 1.0, fade_samples, device),
                      torch.ones(length - fade_samples, device=device)])


def volume_jitter(gen: torch.Generator, length: int, sr: float,
                  speed: float = 6.0, strength: float = 0.1,
                  vibrato: bool = False,
                  device: torch.device | str = "cpu") -> torch.Tensor:
    """Multiplicative volume envelope (ref: GOOFER.py:638-660).

    vibrato=True: zero-phase sinusoid at ``speed`` Hz with a 0.1 s
    fade-in, clipped to [0.5, 1.5] (no random draw).  Otherwise smoothed
    unit noise, unclipped."""
    device = torch.device(device)
    if vibrato:
        t = torch.arange(length, dtype=torch.float32, device=device) / sr
        noise = torch.sin(2.0 * math.pi * speed * t)
        fade = _fade_in(length, int(0.1 * sr), device)
        if fade is not None:
            noise = noise * fade
        return torch.clamp(1.0 + noise * strength, 0.5, 1.5)
    noise = smoothed_unit_noise(gen, length, sr / (speed * 6.0), device)
    return 1.0 + noise * strength


def f0_jitter(gen: torch.Generator, length: int, sr: float,
              speed: float = 40.0, strength: float = 0.04,
              device: torch.device | str = "cpu") -> torch.Tensor:
    """Multiplicative pitch wobble 1 + noise*strength
    (ref: GOOFER.py:662-670)."""
    noise = smoothed_unit_noise(gen, length, sr / (speed * 6.0),
                                torch.device(device))
    return 1.0 + noise * strength


def subharm_vibrato(f0: torch.Tensor, sr: float, rate: float = 6.0,
                    depth: float = 0.1, delay: float = 0.1) -> torch.Tensor:
    """Sinusoidal vibrato on the subharmonic f0 track, voiced samples
    only, with a linear fade-in over ``delay`` seconds
    (ref: GOOFER.py:748-766).  The angular rate is a float32 product, as
    in goofer_tpu's render where ``rate`` is a float32 knob: at 75 Hz a
    one-ulp difference in it moves the vibrato'd f0 by ~0.01 Hz."""
    n = f0.shape[0]
    t = torch.arange(n, dtype=torch.float32, device=f0.device) / sr
    omega = torch.tensor(2.0 * math.pi, dtype=torch.float32) * rate
    vib = torch.sin(omega.item() * t)
    fade = _fade_in(n, int(delay * sr), f0.device)
    if fade is not None:
        vib = vib * fade
    return torch.where(f0 > 0, f0 * (1.0 + vib * depth), f0)
