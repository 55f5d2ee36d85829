#!/usr/bin/env python3
"""Render chip_smoke.py's heavy 11-flag note with goofer_tpu_torch from
several source trees in turn, on one CUDA card, to compare them in one
run.

    python3 tools/torch_heavy_note_ab.py PARENT_ROOT . . PARENT_ROOT

Each ROOT is a checkout holding ``goofer_tpu_torch/`` (for a commit:
``git archive <commit> | tar -x -C <dir>``).  For each, in the order
given, a child process imports the package from that root (building its
kernels into that root's ``build/``), renders the note through the CLI on
CUDA twice to warm up, then ``--reps`` times on the host clock (each
render ends with the WAV written, so it is synchronised), and profiles 5
more with chip_smoke.profile_heavy.  It prints one JSON line per root:
median and all render ms, device busy ms per note, idle share, device
kernels per note and the cascade kernel's device ms per note.  Imports
nothing of JAX or goofer_tpu.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def child(root: Path, reps: int) -> dict:
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    from goofer_tpu_torch import cli

    imported_from = Path(cli.__file__).resolve().parents[1]
    if imported_from != root:
        raise AssertionError(f"imported goofer_tpu_torch from "
                             f"{imported_from}, not from {root}")
    os.environ["GOOFER_TPU_TORCH_DEVICE"] = "cuda"
    name, *args = smoke.HEAVY
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        src = REPO / "tests" / "golden" / "voice"
        shutil.copy(src / "src.wav", tmp / "voice.wav")
        shutil.copy(src / "src_features.goofy", tmp / "voice_features.goofy")
        argv = [str(tmp / "voice.wav"), str(tmp / f"out_{name}.wav")] + [
            str(a) for a in args]
        times = []
        for rep in range(2 + reps):
            t0 = time.perf_counter()
            if cli.main(argv) != 0:
                raise AssertionError(f"render {name}: cli rc != 0")
            torch.cuda.synchronize()
            if rep >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        prof = smoke.profile_heavy(tmp)
    return {"root": str(root), "render_ms_median": statistics.median(times),
            "render_ms": times, **{f"profiled_{k}": v
                                   for k, v in prof.items()}}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("roots", nargs="+", type=Path)
    parser.add_argument("--reps", type=int, default=9)
    parser.add_argument("--child", action="store_true",
                        help=argparse.SUPPRESS)
    ns = parser.parse_args()
    if ns.child:
        print(json.dumps(child(ns.roots[0].resolve(), ns.reps)))
        return 0
    for root in ns.roots:
        proc = subprocess.run(
            [sys.executable, __file__, "--child", "--reps", str(ns.reps),
             str(root.resolve())], capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
