#!/usr/bin/env python3
"""What issuing a mesh's shards from a thread per slot costs on one card.

    python3 tools/torch_mesh_threads.py [--reps 7]

Renders chip_smoke.py's phrases (b) 80 heavy notes and (a) 97 plain
notes from the vendored voice source in turns: on one device; on V, a
dp 2 x tp 2 mesh of four slots of the card, through
devices.run_on_slots (one worker per distinct device: here the calling
thread, every slot's shards in turn); and on V with every slot's shards
issued from a worker thread of its own, the design run_on_slots had
before.  Prints one JSON line per phrase: the median warm wall ms of
each (synchronized, host clock) with the card's name and power limit.
The thread-per-slot form exists only here, as the yardstick.
"""
from __future__ import annotations

import argparse
import json
import shutil
import statistics
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from goofer_tpu_torch import devices  # noqa: E402
from goofer_tpu_torch.parallel import make_mesh  # noqa: E402
from goofer_tpu_torch.sampler import phrase  # noqa: E402


def thread_per_slot(slots, tasks):
    """run_on_slots with one worker thread per slot that has tasks, each
    under device_scope of its slot."""
    out = [[] for _ in slots]

    def work(i):
        with devices.device_scope(slots[i]):
            return [task() for task in tasks[i]]

    with ThreadPoolExecutor(max_workers=len(slots)) as pool:
        futures = [(i, pool.submit(work, i))
                   for i, todo in enumerate(tasks) if todo]
    for i, future in futures:
        out[i] = future.result()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mesh_threads: CUDA is not available", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    dev = torch.device("cuda", 0)
    v = make_mesh(4, tp=2, devices=[dev] * 4)
    one_worker = devices.run_on_slots
    with tempfile.TemporaryDirectory() as tmp:
        for ext in (".wav", "_features.goofy"):
            shutil.copy(chip_smoke.REPO / "tests" / "golden" / "voice"
                        / f"src{ext}", Path(tmp) / f"voice{ext}")
        sung = chip_smoke.phrase_notes(str(Path(tmp) / "voice.wav"))
        for name in ("b", "a"):
            notes = sung[name]
            runs = {
                "single": lambda: phrase.render_phrase(notes, pcm16=True,
                                                       device=dev),
                "V": lambda: phrase.render_phrase(notes, pcm16=True,
                                                  mesh=v),
                "V_thread_per_slot": lambda: phrase.render_phrase(
                    notes, pcm16=True, mesh=v),
            }
            times = {k: [] for k in runs}
            for rep in range(2 + args.reps):
                for k, fn in runs.items():
                    phrase.run_on_slots = (thread_per_slot
                                           if k == "V_thread_per_slot"
                                           else one_worker)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    if rep >= 2:
                        times[k].append((time.perf_counter() - t0) * 1e3)
            phrase.run_on_slots = one_worker
            print(json.dumps({
                "phrase": name, "notes": len(notes), "card": card,
                "reps": args.reps,
                "wall_ms_median": {k: statistics.median(t)
                                   for k, t in times.items()},
                "wall_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
