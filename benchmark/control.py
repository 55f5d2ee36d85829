"""The control of ``correct``: the plain reference put in the program's
place and computed one precision below the configuration's must come
out as not correct.

    python benchmark/control.py --workload <name> --seeds 1 2 3

The configuration states float32 with TF32 off.  TF32 changes no bit of
this render (no op of it runs on tensor cores), so the control rounds
every float32 tensor the reference's ops return to bfloat16, as a render
that stores its signals in bfloat16 would hold them (float64 phases and
integers stay).

For each seed it draws the notes a run of the cell compares (the keep
rule of harness.Runner over the window's requests, and the longest of
them), renders each in bfloat16, quantizes it as the cell's
entry does, and compares it with the float32 reference through
check.compare.  Prints one JSON line per seed with the numbers beside
the configuration's limits.  The benchmark's own runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _bf16_mode():
    """A torch function mode that rounds every float32 tensor an op
    returns to bfloat16."""
    import torch
    from torch.overrides import TorchFunctionMode

    def lower(x):
        if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
            return x.to(torch.bfloat16).to(torch.float32)
        if isinstance(x, (tuple, list)):
            return type(x)(lower(v) for v in x)
        return x

    class Bf16(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            return lower(func(*args, **(kwargs or {})))

    return Bf16()


class Lowered:
    """check.Reference's interface, rendering in bfloat16."""

    def __init__(self, ref):
        self.ref = ref

    def pcm(self, r):
        with _bf16_mode():
            return self.ref.pcm(r)


def sample(mix: dict, gen, entry, seed: int) -> list:
    """The records a run would compare, from the window's requests."""
    from benchmark import traffic

    g = traffic.rng(seed, traffic.CHECK)
    kept, longest = [], None
    window = gen.window()
    while len(kept) < mix["check"]["compared"]:
        notes = next(window)
        u = g.random(len(notes))
        for j, n in enumerate(notes):
            rec = {"note": n, "request": notes, "key": entry.noise_key(j)}
            if u[j] < mix["check"]["keep_share"]:
                kept.append(rec)
            if longest is None or n["audio_ms"] > longest["note"]["audio_ms"]:
                longest = rec
    return kept[:mix["check"]["compared"]] + (
        [] if longest in kept else [longest])


def control(workload: str, seed: int, device: str = "cuda",
            compared: int | None = None) -> dict:
    """The control's numbers for ``seed``; ``compared`` draws fewer notes
    than a run compares (a test's size)."""
    import importlib

    import numpy as np
    from scipy.io import wavfile

    from benchmark import check, harness, traffic
    from benchmark.voicebank import Voicebank

    spec = harness.load_spec()
    _, config, mix = harness.cell_parts(spec, workload)
    if compared is not None:
        mix = dict(mix, check=dict(mix["check"], compared=compared))
    entry = importlib.import_module(
        f"benchmark.entries.{config['entry']}").Entry
    bank = Voicebank(config["voicebank"])
    out = Path(tempfile.mkdtemp(prefix="bench_control_"))
    try:
        ref = check.Reference(bank, config, entry, device)
        low = Lowered(ref)
        gen = traffic.Traffic(mix, bank.aliases, bank.oto, seed)
        gen.warmup()
        records = sample(mix, gen, entry, seed)
        for i, r in enumerate(records):
            r["path"] = out / f"{i}.wav"
            wavfile.write(str(r["path"]), config["sample_rate"],
                          np.asarray(low.pcm(r), dtype=np.int16))
        worst = check.compare(records, ref, config["sample_rate"])
        worst["failed"] = 0
        correct, checks = check.judge(worst, config["limits"])
        return {"workload": workload, "seed": seed, "notes": len(records),
                "correct": correct, "checks": checks}
    finally:
        import shutil

        shutil.rmtree(out, ignore_errors=True)
        bank.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(control(args.workload, seed)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
