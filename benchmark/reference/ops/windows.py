"""Frozen copy of goofer_tpu_torch/ops/windows.py for the benchmark's plain reference:
the plain PyTorch versions of the hand kernels only.

Window / static spectral curve constructors.

These return NumPy arrays: shape-static constants, built once per
(sr, n_fft) and moved to the render's device by the callers.  A JAX-free
copy of goofer_tpu/ops/windows.py.
"""
from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def sqrt_hann_window(n_fft: int) -> np.ndarray:
    """Square-root Hann analysis/synthesis window (ref: GOOFER.py:12-18).

    The reference uses ``hanning(n_fft) ** 0.5`` for both STFT and iSTFT so
    the round-trip applies a full Hann with win**2 OLA normalization.
    """
    return (np.hanning(n_fft).astype(np.float32)) ** 0.5


@functools.lru_cache(maxsize=None)
def rfft_freqs(sr: int, n_fft: int) -> np.ndarray:
    """Column vector of rfft bin frequencies in Hz (ref: GOOFER.py:20-26)."""
    return np.fft.rfftfreq(n_fft, 1.0 / sr).astype(np.float32).reshape(-1, 1)


@functools.lru_cache(maxsize=None)
def boost_curve(n_fft: int) -> np.ndarray:
    """Linear 1 -> 100 spectral tilt over bins, part of the harmonic timbre
    (ref: GOOFER.py:28-35).  Shape (n_bins, 1)."""
    n_bins = n_fft // 2 + 1
    return np.linspace(1.0, 100.0, n_bins, dtype=np.float32).reshape(-1, 1)


def brightness_curve(
    n_bins: int, sr: int, start_hz: float, end_hz: float, gain_db: float
) -> np.ndarray:
    """Piecewise-linear high-shelf gain curve (ref: GOOFER.py:585-595).

    Unity below ``start_hz``, linear rise to ``10**(gain_db/20)`` at
    ``end_hz``, flat shelf above.  Shape (n_bins, 1).
    """
    freqs = np.linspace(0.0, sr / 2.0, n_bins)
    gain = np.ones_like(freqs)
    i0 = np.searchsorted(freqs, start_hz)
    i1 = np.searchsorted(freqs, end_hz)
    rise = np.linspace(0.0, 1.0, i1 - i0)
    lin_gain = 10.0 ** (gain_db / 20.0)
    gain[i0:i1] = 1.0 + rise * (lin_gain - 1.0)
    gain[i1:] = lin_gain
    return gain[:, None].astype(np.float32)


@functools.lru_cache(maxsize=None)
def brightness_curves(sr: int, n_fft: int) -> tuple:
    """(harmonic shelf, breath shelf) used by synthesize
    (ref: GOOFER.py:37-46): harmonic 2000->3500 Hz +3 dB,
    breath 3500->5000 Hz +20 dB."""
    n_bins = n_fft // 2 + 1
    harm = brightness_curve(n_bins, sr, 2000.0, 3500.0, 3.0)
    brea = brightness_curve(n_bins, sr, 3500.0, 5000.0, 20.0)
    return harm, brea
