#!/usr/bin/env python3
"""Where the host's time goes in goofer_tpu_torch's folder extraction:
cProfile over warm runs of extract_features_batch on chip_smoke.py's
64-file voicebank (decoded beforehand, lean output), on one CUDA device.

    python3 tools/torch_extract_host_profile.py [--reps 3] [--top 30]

Prints the card's name and power limit, each warm run's wall ms (host
clock, synchronized) and the profile's top functions by cumulative and
by own time.  The profiler's own overhead is in the profiled numbers;
the warm runs before it are not profiled.
"""
from __future__ import annotations

import argparse
import cProfile
import pstats
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from goofer_tpu_torch.analysis import features  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    print(cs.card_line())
    cuts = [cs.pcm16(y) for y in cs.voicebank_cuts()]

    def extract():
        features.extract_features_batch(cuts, cs.SR, cs.N_FFT, cs.HOP,
                                        dense=False)
        torch.cuda.synchronize()

    for _ in range(3):
        t0 = time.perf_counter()
        extract()
        print(f"warm run: {(time.perf_counter() - t0) * 1e3:.3f} ms")
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(args.reps):
        extract()
    prof.disable()
    print(f"profile of {args.reps} runs (divide by {args.reps} for one):")
    stats = pstats.Stats(prof)
    stats.sort_stats("cumulative").print_stats(args.top)
    stats.sort_stats("tottime").print_stats(args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
