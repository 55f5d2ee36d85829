"""The control of ``correct``: the plain reference put in the program's
place and computed one precision below the configuration's must come
out as not correct.

    python benchmark/control.py --workload <name> --seeds 1 2 3

For each seed it runs the cell's parts as a run does (harness.deployment):
the warm-up, then window requests until ``compared`` of their items are
drawn, so ``harness.Runner`` keeps the items a run of that many requests
would compare.  The comparer's ``control`` then writes the lowered
reference's output over each of them and judges it; ``check.judge``
holds its numbers, with ``failed`` 0, to the configuration's limits.
Prints one JSON line per seed with the numbers beside those limits.  The
benchmark's own runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def control(workload: str, seed: int, device: str = "cuda",
            compared: int | None = None, spec: dict | None = None,
            mix: dict | None = None) -> dict:
    """The control's numbers for ``seed``; ``compared`` draws fewer items
    than a run compares (a test's size)."""
    from benchmark import check, harness

    spec = spec or harness.load_spec()
    _, config, mix = harness.cell_parts(spec, workload, mix)
    if compared is not None:
        mix = dict(mix, check=dict(mix["check"], compared=compared))
    parts = harness.deployment(config, mix)
    inputs = parts.inputs.build(config)
    out = Path(tempfile.mkdtemp(prefix="bench_control_"))
    try:
        gen = parts.generators.generator(mix, inputs, seed)
        runner = harness.Runner(parts.entry(config, inputs), mix, seed,
                                config["sample_rate"], out, gen)
        runner.warm_up(gen.warmup())
        window = gen.window()
        while len(runner.kept) < mix["check"]["compared"]:
            if not runner.send(next(window), keep=True)[1]:
                raise RuntimeError("a window request failed")
        records = runner.compared(seed)
        numbers = parts.comparer.control(records, inputs, config,
                                         parts.entry, device)
        numbers["failed"] = 0
        correct, checks = check.judge(numbers, config["limits"])
        return {"workload": workload, "seed": seed, "items": len(records),
                "correct": correct, "checks": checks}
    finally:
        shutil.rmtree(out, ignore_errors=True)
        inputs.close()


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
