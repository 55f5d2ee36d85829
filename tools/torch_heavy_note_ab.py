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
more with chip_smoke.profile_heavy.  Then it times one ``pulse_train``
pass on the heavy note's main-layer f0, n and K (recorded from a render):
device ms per pass over 100 passes between one pair of CUDA events
(behind a spin, but the host may fall behind it: whatever the device
waits is part of the pass), and from torch.profiler the summed device
time and the device kernels per pass.  It prints one JSON line per root:
median and all render ms, device busy ms per note, idle share, device
kernels per note, the kernels' device ms per note and the pulse pass.
Imports nothing of JAX or goofer_tpu.
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
        pass_ = pulse_pass(smoke, argv)
    return {"root": str(root), "render_ms_median": statistics.median(times),
            "render_ms": times, **{f"profiled_{k}": v
                                   for k, v in prof.items()}, **pass_}


def pulse_pass(smoke, argv, reps: int = 100) -> dict:
    """Time the heavy note's main-layer pulse_train pass on its own."""
    import torch
    from goofer_tpu_torch import cli
    from goofer_tpu_torch.engine import synth
    from goofer_tpu_torch.ops import pulse

    calls = []
    real = synth.pulse_train

    def record(f0, sr, **kw):
        calls.append((f0.clone(), sr, kw))
        return real(f0, sr, **kw)

    synth.pulse_train = record
    try:
        if cli.main(argv) != 0:
            raise AssertionError("pulse pass: cli rc != 0")
    finally:
        synth.pulse_train = real
    f0, sr, kw = calls[0]

    def one():
        return pulse.pulse_train(f0, sr, **kw)

    ms = smoke.cuda_ms(one, reps, gap_free=False)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            one()
        torch.cuda.synchronize()
    kernels = [e for e in smoke.device_events(prof)
               if not e.name.startswith(("Memcpy", "Memset"))]
    return {"pulse_pass_n": int(f0.shape[-1]), "pulse_pass_args": kw,
            "pulse_pass_ms": ms,
            "pulse_pass_device_ms": sum(e.time_range.elapsed_us()
                                        for e in kernels) / 1e3 / reps,
            "pulse_pass_kernels": len(kernels) / reps}


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
