"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s>
                            --trace <0|1>

Runs from the root of a checkout on a machine with the cards the cell
asks for; it never falls back to the CPU.  The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, then the
numbers compared beside their limits under ``checks``); those numbers
are also the last lines of standard error.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout
CACHE = REPO / "build" / "bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
sys.path.insert(0, str(REPO))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    spec = harness.load_spec()
    cell = next((w for w in spec["workloads"] if w["name"] == args.workload),
                None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
              f"{cell['chips']}", file=sys.stderr)
        return 3
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), spec=spec)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded modules the benchmark must not load: {found}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
