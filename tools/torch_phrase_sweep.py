#!/usr/bin/env python3
"""How phrase size moves the port's render between host-bound and
device-bound, on one CUDA card.

    python3 tools/torch_phrase_sweep.py [--sizes 1 10 20 40 80 160 320]

For one group of B equal-length notes sung from the vendored voice source
(plain ``t`` flags, 60 + 500 ms; and the heavy 11-flag stack, 60 + 690
ms, as chip_smoke.py's phrases (a) and (b)) it prints one JSON line per
(kind, B): warm wall ms of ``render_phrase(pcm16=True)`` (median of 7
after 2 warm runs, synchronized), x realtime, and from torch.profiler over
3 renders the device busy ms, idle share and device kernels per phrase,
and the peak device memory.  The first line names the card and its power
limit.  The device stops idling where the idle share nears 0: beyond
that size wall time grows with B.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from goofer_tpu_torch.sampler import phrase  # noqa: E402


def measure(notes) -> dict:
    def render():
        phrase.render_phrase(notes, pcm16=True)

    wall_ms = smoke._median_ms(render, 7)
    torch.cuda.reset_peak_memory_stats()
    reps = 3
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            render()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    busy_us, kernels = smoke.device_busy(prof)
    audio_s = smoke._audio_s(notes)
    return {
        "notes": len(notes), "audio_s": audio_s, "wall_ms": wall_ms,
        "x_realtime": audio_s * 1e3 / wall_ms,
        "device_busy_ms": busy_us / 1e3 / reps,
        "idle_share": 1.0 - busy_us / 1e3 / prof_ms,
        "device_kernels": len(kernels) / reps,
        "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[1, 10, 20, 40, 80, 160, 320])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_phrase_sweep: CUDA is not available", file=sys.stderr)
        return 1
    print(json.dumps({"card": smoke.card_line()}))
    with tempfile.TemporaryDirectory() as tmp:
        voice = REPO / "tests" / "golden" / "voice"
        shutil.copy(voice / "src.wav", Path(tmp) / "voice.wav")
        shutil.copy(voice / "src_features.goofy",
                    Path(tmp) / "voice_features.goofy")
        src = str(Path(tmp) / "voice.wav")
        kinds = {"plain": ("", 500), "heavy": (smoke.HEAVY[3], 690)}
        for kind, (flags, length) in kinds.items():
            for b in args.sizes:
                notes = [phrase.NoteSpec(
                    src, smoke.PHRASE_SCALE[i % 10], length=length,
                    consonant=60, flags=flags + f"t{(i % 7 - 3) * 10}")
                    for i in range(b)]
                print(json.dumps({"kind": kind, **measure(notes)}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
