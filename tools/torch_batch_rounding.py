#!/usr/bin/env python3
"""Why a folder row's envelope knots differ from the same file's alone:
which op of goofer_tpu_torch's envelope analysis rounds differently when
the batch size changes, on one CUDA device.

    python3 tools/torch_batch_rounding.py [--rows 0 7 20]

Takes the largest chunk of chip_smoke.py's 64-file voicebank (B rows at one
padded length) and, for each chosen row, runs the same data at batch size B
and at batch size 1 through, in turn:

  frames   the windowed STFT frames (pad, unfold, window): no arithmetic
           that depends on B
  rfft     torch.fft.rfft of identical frames (cuFFT)
  blur     ops/filters.py:gaussian_blur1d of identical magnitudes (cuDNN
           conv1d)
  env      the two together, as analysis/features.py:analyze_chunk runs them
  knots    the float16 log-envelope knots of extract_features_batch, the
           row in its chunk against the file alone

and prints per stage the share of bit-equal values, the largest difference
relative to the frame's largest value, and for the knots the largest
difference in float16 steps with and without chip_smoke.py's float32
floor.  Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from goofer_tpu_torch.analysis import features  # noqa: E402
from goofer_tpu_torch.ops.filters import (  # noqa: E402
    gaussian_blur1d,
    reflect_pad,
)
from goofer_tpu_torch.ops.stft import stft  # noqa: E402
from goofer_tpu_torch.ops.windows import sqrt_hann_window  # noqa: E402


def windowed_frames(y: torch.Tensor) -> torch.Tensor:
    """(B, T, n_fft): the frames ops/stft.py:stft transforms."""
    pad = cs.N_FFT // 2
    xp = reflect_pad(y, pad, pad)
    win = torch.as_tensor(sqrt_hann_window(cs.N_FFT), device=y.device)
    return xp.unfold(-1, cs.N_FFT, cs.HOP) * win


def report(stage: str, batched: torch.Tensor, alone: torch.Tensor,
           frame_axis_peak: int) -> None:
    """``batched`` and ``alone`` hold one row's values; the peak is taken
    along ``frame_axis_peak`` (the axis that runs over a frame's bins)."""
    a, b = batched.abs().double(), alone.abs().double()
    peak = torch.maximum(a, b).amax(dim=frame_axis_peak, keepdim=True)
    diff = (batched - alone).abs().double()
    rel = float((diff / peak.clamp_min(1e-30)).max())
    same = float((batched == alone).double().mean())
    print(f"  {stage}: bit-equal share {same:.4f}, max |diff| / frame peak "
          f"{rel:.3e}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="*", default=[0, 7, 20])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    print(cs.card_line())
    dev = torch.device("cuda")
    (y, n_true, *_), n_files = cs.bank_chunk(dev)
    print(f"chunk: B={n_files} rows of {y.shape[1]} padded samples")

    cuts = [cs.pcm16(c) for c in cs.voicebank_cuts()]
    plan = list(features.chunk_plan([len(c) for c in cuts], cs.HOP,
                                    features.EXTRACT_CHUNK_FILES,
                                    features.EXTRACT_CHUNK_FRAMES))
    _, part = max(plan, key=lambda c: len(c[1]) * c[0])
    in_chunk = features.extract_features_batch(
        [cuts[i] for i in part], cs.SR, cs.N_FFT, cs.HOP, dense=False)

    frames_b = windowed_frames(y)
    spec_b = torch.fft.rfft(frames_b, dim=-1)
    mag_b = spec_b.abs().transpose(-1, -2) + 1e-8          # (B, bins, T)
    blur_b = gaussian_blur1d(mag_b, 2.0, axis=-2)
    env_b = gaussian_blur1d(stft(y, cs.N_FFT, cs.HOP).abs() + 1e-8, 2.0,
                            axis=-2)
    for r in args.rows:
        r = r % n_files
        one = y[r:r + 1]
        print(f"row {r} ({int(n_true[r])} true samples):")
        frames_1 = windowed_frames(one)
        report("frames", frames_b[r], frames_1[0], -1)
        # identical frames in, so only the transform's batch size differs
        spec_1 = torch.fft.rfft(frames_b[r:r + 1].contiguous(), dim=-1)
        report("rfft  ", torch.view_as_real(spec_b[r]).flatten(-2),
               torch.view_as_real(spec_1[0]).flatten(-2), -1)
        # identical magnitudes in, so only the blur's batch size differs
        blur_1 = gaussian_blur1d(mag_b[r:r + 1].contiguous(), 2.0, axis=-2)
        report("blur  ", blur_b[r], blur_1[0], 0)
        env_1 = gaussian_blur1d(stft(one, cs.N_FFT, cs.HOP).abs() + 1e-8,
                                2.0, axis=-2)
        report("env   ", env_b[r], env_1[0], 0)
        alone = features.extract_features(cuts[part[r]], cs.SR, cs.N_FFT,
                                          cs.HOP, dense=False)
        k_b = np.asarray(in_chunk[r][4]["knot_vals_log"])
        k_a = np.asarray(alone[4]["knot_vals_log"])
        if k_a.shape != k_b.shape:
            print(f"  knots : K {k_b.shape[0]} in the chunk, {k_a.shape[0]} "
                  "alone")
            continue
        big = np.maximum(np.abs(k_a), np.abs(k_b))
        raw = np.abs(k_a.astype(np.float32) - k_b.astype(np.float32)) \
            / np.spacing(big.astype(np.float16)).astype(np.float32)
        worst_knot = np.unravel_index(raw.argmax(), raw.shape)[0]
        print(f"  knots : K {k_a.shape[0]}, bit-equal share "
              f"{float((k_a == k_b).mean()):.4f}, max diff {raw.max():.1f} "
              f"float16 steps raw (knot {worst_knot} of {k_a.shape[0]}), "
              f"{cs.knot_steps(k_a, k_b):.3f} above the float32 floor of "
              f"{cs.KNOT_F32_FLOOR} x frame peak")
    return 0


if __name__ == "__main__":
    sys.exit(main())
