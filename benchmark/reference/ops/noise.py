"""Frozen copy of goofer_tpu_torch/ops/noise.py for the benchmark's plain reference:
the plain PyTorch versions of the hand kernels only.

Counter-based random draws keyed per row.

goofer_tpu keys every note of a phrase by (seed, note index) and every
noise frame by its frame number (engine/synth.py:_frame_phases), so a
note's noise depends neither on the notes that share its batch nor on
the padded length of a bucketed render.  One ``torch.Generator`` drawn
across a (B, m) tensor has neither property, and B generators cost B
launches per draw.  Here a draw is a pure function of (row key, counter):
SplitMix64 (Steele, Lea & Flood 2014) evaluated on ``key + (i + 1) *
GOLDEN`` in wrapping int64 arithmetic, a dozen elementwise ops over the
whole (B, m) tensor whatever B is, the same bits on the CPU and on the
card.  Row b's element i depends only on ``keys[b]`` and i: a longer
draw extends a shorter one, and rows never interact.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _i64(x: int) -> int:
    """An unsigned 64-bit constant as the signed value of the same bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


GOLDEN = _i64(0x9E3779B97F4A7C15)
MIX1 = _i64(0xBF58476D1CE4E5B9)
MIX2 = _i64(0x94D049BB133111EB)


def stream_keys(seeds, n_streams: int) -> np.ndarray:
    """(B, n_streams) int64 keys, row b from ``SeedSequence(seeds[b])``;
    a seed is an int or a tuple of ints such as (seed, note index)."""
    rows = [np.random.SeedSequence(s).generate_state(n_streams, np.uint64)
            for s in seeds]
    return np.stack(rows).view(np.int64)


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _mix(z: torch.Tensor) -> torch.Tensor:
    """SplitMix64's output function on int64 bit patterns."""
    z = (z ^ _shr(z, 30)) * MIX1
    z = (z ^ _shr(z, 27)) * MIX2
    return z ^ _shr(z, 31)


def random_bits(keys: torch.Tensor, m: int) -> torch.Tensor:
    """(B, m) int64 bit patterns: SplitMix64 outputs 1..m of each row's
    key (B,) int64."""
    ctr = torch.arange(1, m + 1, dtype=torch.int64, device=keys.device)
    return _mix(keys[:, None] + ctr * GOLDEN)


def fold_in(keys: torch.Tensor, data: int) -> torch.Tensor:
    """(B,) keys of sub-stream ``data`` >= 0 of each row's key: its
    draw ``data`` (``random_bits(keys, data + 1)[:, data]``), the
    counterpart of ``jax.random.fold_in``."""
    return _mix(keys + _i64((data + 1) * GOLDEN % (1 << 64)))


def uniform(keys: torch.Tensor, m: int) -> torch.Tensor:
    """(B, m) float32 uniform on [0, 1): the top 24 bits of each draw."""
    return _shr(random_bits(keys, m), 40).float() * 2.0 ** -24


def normal(keys: torch.Tensor, m: int) -> torch.Tensor:
    """(B, m) float32 standard normal by Box-Muller from the two 24-bit
    halves of each draw's top 48 bits."""
    z = random_bits(keys, m)
    u1 = (_shr(z, 40).float() + 0.5) * 2.0 ** -24
    u2 = (_shr(z, 16) & 0xFFFFFF).float() * 2.0 ** -24
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
