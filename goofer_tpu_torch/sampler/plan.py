"""Host-side note planning: cuts, sustain loops and velocity warps as
index/weight gather plans.

A JAX-free copy of goofer_tpu/sampler/plan.py; ``apply_frame_plan``
materializes a plan on a tensor on the caller's device (the batched
render applies its (B, T') plans itself, render_core._apply_plan).

The reference assembles note features with Python list surgery
(ref: SillySampler.py:449-788).  Here the host computes, per note, small
NumPy index/weight arrays describing every frame/sample of the output as a
one- or two-source blend of the cut features; the device then materializes
them with O(1) fused gathers.  Plans are pure functions of the note
arguments (no audio data), so planning costs microseconds and the heavy
math stays on the device.

A frame plan is (pos0, pos1, w): out[.., t] = lerp-gather(src, pos0[t]) *
(1 - w[t]) + lerp-gather(src, pos1[t]) * w[t], positions fractional.
Plan constructors are memoized: notes of a phrase overwhelmingly share
cut/loop/velocity geometry, so repeated notes reuse one plan object (which
also lets the phrase batcher dedupe the arrays by identity).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from goofer_tpu_torch.ops.interp import gather_lerp


@dataclass
class FramePlan:
    pos0: np.ndarray
    pos1: np.ndarray
    w: np.ndarray

    @staticmethod
    def single(pos: np.ndarray) -> "FramePlan":
        pos = np.asarray(pos, dtype=np.float32)
        return FramePlan(pos, pos, np.zeros(len(pos), dtype=np.float32))

    def __len__(self) -> int:
        return len(self.pos0)


def apply_frame_plan(src: torch.Tensor, plan: FramePlan,
                     axis: int = -1) -> torch.Tensor:
    """Materialize a plan along ``axis`` of ``src``, on its device."""
    pos0, pos1, w = (torch.as_tensor(a, device=src.device)
                     for a in (plan.pos0, plan.pos1, plan.w))
    a = gather_lerp(src, pos0, axis=axis)
    b = gather_lerp(src, pos1, axis=axis)
    shape = [1] * src.ndim
    shape[axis] = -1
    w = w.reshape(shape)
    return a * (1.0 - w) + b * w


# ---------------------------------------------------------------------------
# Cut geometry (ref: SillySampler.py:453-500)
# ---------------------------------------------------------------------------

@dataclass
class CutPlan:
    start_sample: int
    consonant_sample: int
    end_sample: int
    start_frame: int
    consonant_frame: int
    end_frame: int


def plan_cut(sample_len_sec: float, sr: int, hop: int, offset_sec: float,
             consonant_sec: float, cutoff_sec: float,
             reverse: bool) -> CutPlan:
    start_sec_base = offset_sec
    if cutoff_sec < 0:
        end_sec_base = offset_sec - cutoff_sec
    else:
        end_sec_base = sample_len_sec - cutoff_sec

    if reverse:
        length = end_sec_base - start_sec_base
        offset_used = sample_len_sec - end_sec_base
        cutoff_used = sample_len_sec - (offset_used + length)
    else:
        offset_used = offset_sec
        cutoff_used = cutoff_sec

    start_sample = int(offset_used * sr)
    consonant_sample = start_sample + int(consonant_sec * sr)
    if cutoff_used < 0:
        end_sec = offset_used - cutoff_used
    else:
        end_sec = sample_len_sec - cutoff_used
    end_sample = int(end_sec * sr)

    return CutPlan(
        start_sample=start_sample,
        consonant_sample=consonant_sample,
        end_sample=end_sample,
        start_frame=start_sample // hop,
        consonant_frame=consonant_sample // hop,
        end_frame=end_sample // hop,
    )


# ---------------------------------------------------------------------------
# Sustain loop plans (ref: SillySampler.py:625-749)
# ---------------------------------------------------------------------------

def _concat_loop_sections(tail: int, desired: int):
    """Frame plan for the concat mode's seam-crossfaded loop, reproducing
    the reference's construction (including its longer-than-desired output,
    ref: SillySampler.py:654-696).  Positions index the tail (0..tail-1)."""
    reps = desired // tail
    rem = desired % tail
    f = min(8, tail // 2)

    pos0_parts, pos1_parts, w_parts = [], [], []

    def chunk(fade: int, b_src, b_len: int):
        """prev[:-fade] ++ crossfade ++ b_src[fade:] where prev = tail."""
        p0 = [np.arange(tail - fade)]
        p1 = [np.arange(tail - fade)]
        w = [np.zeros(tail - fade)]
        if fade > 0:
            p0.append(np.arange(tail - fade, tail))     # A = prev tail end
            p1.append(b_src[:fade])                     # B = next start
            w.append(np.linspace(0.0, 1.0, fade))
        p0.append(b_src[fade:b_len])
        p1.append(b_src[fade:b_len])
        w.append(np.zeros(max(0, b_len - fade)))
        return (np.concatenate(p0), np.concatenate(p1), np.concatenate(w))

    tail_idx = np.arange(tail)
    for _ in range(reps - 1):
        p0, p1, w = chunk(f, tail_idx, tail)
        pos0_parts.append(p0)
        pos1_parts.append(p1)
        w_parts.append(w)

    if rem:
        fr = min(8, rem // 2)
        if fr > 0:
            p0, p1, w = chunk(fr, tail_idx, rem)
        else:
            p0 = np.concatenate([tail_idx, tail_idx[:rem]])
            p1 = p0.copy()
            w = np.zeros(len(p0))
        pos0_parts.append(p0)
        pos1_parts.append(p1)
        w_parts.append(w)
    else:
        pos0_parts.append(tail_idx)
        pos1_parts.append(tail_idx)
        w_parts.append(np.zeros(tail))

    return (np.concatenate(pos0_parts), np.concatenate(pos1_parts),
            np.concatenate(w_parts))


@functools.lru_cache(maxsize=4096)
def plan_env_loop(pre: int, tail: int, desired: int, mode: str) -> FramePlan:
    """Plan for the looped envelope: positions index the cut env columns
    (0..pre-1 prefix, pre..pre+tail-1 tail)."""
    pre_idx = np.arange(pre, dtype=np.float64)

    if tail >= desired:
        tail_pos = np.arange(desired, dtype=np.float64)
        p0 = p1 = np.concatenate([pre_idx, pre + tail_pos])
        return FramePlan(p0.astype(np.float32), p1.astype(np.float32),
                         np.zeros(len(p0), dtype=np.float32))

    if mode == "stretch":
        if tail == 0:
            tail_pos = np.zeros(desired)
            w = np.zeros(desired)
            p0 = np.concatenate([pre_idx, pre + tail_pos])
            return FramePlan(p0.astype(np.float32), p0.astype(np.float32),
                             np.zeros(len(p0), dtype=np.float32))
        target = int(tail * (desired / tail))
        tail_pos = np.linspace(0.0, tail - 1.0, target)
        p0 = np.concatenate([pre_idx, pre + tail_pos])
        return FramePlan(p0.astype(np.float32), p0.astype(np.float32),
                         np.zeros(len(p0), dtype=np.float32))

    if mode == "avg":
        reps = desired // tail
        rem = desired % tail
        p = np.tile(np.arange(tail), reps)
        if rem:
            p = np.concatenate([p, np.arange(rem)])
        p0 = np.concatenate([pre_idx, pre + p])
        p1 = np.concatenate([pre_idx, pre + (tail - 1 - p)])
        w = np.concatenate([np.zeros(pre), np.full(len(p), 0.5)])
        return FramePlan(p0.astype(np.float32), p1.astype(np.float32),
                         w.astype(np.float32))

    # concat
    p0, p1, w = _concat_loop_sections(tail, desired)
    p0 = np.concatenate([pre_idx, pre + p0])
    p1 = np.concatenate([pre_idx, pre + p1])
    w = np.concatenate([np.zeros(pre), w])
    return FramePlan(p0.astype(np.float32), p1.astype(np.float32),
                     w.astype(np.float32))


@functools.lru_cache(maxsize=4096)
def plan_track_loop(pre: int, tail: int, desired: int, mode: str) -> FramePlan:
    """Formant-track loop plan (no crossfade in concat mode,
    ref: SillySampler.py:717-744)."""
    pre_idx = np.arange(pre, dtype=np.float64)
    if mode == "stretch":
        if tail == 0:
            tail_pos = np.zeros(desired)
        else:
            target = int(tail * (desired / tail))
            tail_pos = np.linspace(0.0, tail - 1.0, target)
        p0 = np.concatenate([pre_idx, pre + tail_pos])
        return FramePlan(p0.astype(np.float32), p0.astype(np.float32),
                         np.zeros(len(p0), dtype=np.float32))
    if tail == 0:
        tail_pos = np.zeros(desired)
        p0 = np.concatenate([pre_idx, pre + tail_pos])
        return FramePlan(p0.astype(np.float32), p0.astype(np.float32),
                         np.zeros(len(p0), dtype=np.float32))
    reps = desired // tail
    rem = desired % tail
    p = np.tile(np.arange(tail), reps)
    if rem:
        p = np.concatenate([p, np.arange(rem)])
    if mode == "avg":
        p0 = np.concatenate([pre_idx, pre + p])
        p1 = np.concatenate([pre_idx, pre + (tail - 1 - p)])
        w = np.concatenate([np.zeros(pre), np.full(len(p), 0.5)])
        return FramePlan(p0.astype(np.float32), p1.astype(np.float32),
                         w.astype(np.float32))
    p0 = np.concatenate([pre_idx, pre + p])
    return FramePlan(p0.astype(np.float32), p0.astype(np.float32),
                     np.zeros(len(p0), dtype=np.float32))


@functools.lru_cache(maxsize=4096)
def plan_sample_loop(pre: int, tail: int, desired: int) -> FramePlan:
    """f0/mask loop: always plain tiling (ref: SillySampler.py:698-712)."""
    pre_idx = np.arange(pre, dtype=np.float64)
    if tail >= desired:
        p = np.arange(desired)
    else:
        reps = desired // tail
        rem = desired % tail
        p = np.tile(np.arange(tail), reps)
        if rem:
            p = np.concatenate([p, np.arange(rem)])
    p0 = np.concatenate([pre_idx, pre + p])
    return FramePlan(p0.astype(np.float32), p0.astype(np.float32),
                     np.zeros(len(p0), dtype=np.float32))


# ---------------------------------------------------------------------------
# Velocity prefix warp (ref: SillySampler.py:176-209, 766-788)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4096)
def plan_prefix_stretch(n: int, pre_len: int, factor: float):
    """Fractional source positions for the consonant-velocity time warp, or
    None when the reference would leave the data untouched."""
    if pre_len <= 1 or n <= 1 or abs(factor - 1.0) < 1e-6:
        return None
    pre_new = max(1, int(round(pre_len * factor)))
    n_new = pre_new + (n - pre_len)
    idx = np.arange(n_new, dtype=np.float64)
    pos = np.where(idx < pre_new, idx / factor, (idx - pre_new) + pre_len)
    return FramePlan.single(pos)
