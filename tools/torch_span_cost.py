#!/usr/bin/env python3
"""The cost and the readings of goofer_tpu_torch's own spans
(utils/profiling.py) on one CUDA card.

    python3 tools/torch_span_cost.py [--rounds 3] [--seed N]
                                     [--out DIR]

In one process, after the card's name and power limit:

1. the host's cost of a span: ns per ``with span(...)`` block, per call
   through a ``traced`` function, per run of five ``phases`` marks and per
   ``with request()`` (an entry point's, no request open), spans off and
   on, against a plain call (10^6 each, best of 3; each includes its
   loop's own step);
2. for each benchmark cell (``song.heavy_fresh``, ``note.heavy_fresh``:
   BENCHMARK.json's configuration, voicebank and traffic from ``--seed``),
   after its warm-up requests:
   - the spans one request opens, per note, by kind (spans on), and from
     those and step 1 the off spans' ns a note;
   - request ms with spans off and on, ``--rounds`` rounds of the cell's
     ``trace_requests`` fresh requests each way, in turns;
   - the host ms of each span and the counters of ``trace_requests`` more,
     from the registry, and their host time no leaf span names;
   - device traces of ``trace_requests`` more: the note's own
     (GOOFER_TPU_TRACE_DIR set, one trace a note), the song's through
     ``utils/profiling.py:device_trace`` around them (the program's
     spans on in both).  Per trace file: the host ms of each span, the
     device's idle gaps summed by the innermost program span the host was
     in at the gap's middle (``outside_spans`` where in none; the trace's
     own clock), and the device ms each span launched (a device event is
     tied to its launch by the CUDA correlation id); summed over the
     files.  One trace file is kept, gzipped.

Prints one JSON line per cell and writes each under ``--out`` (default
``build/span_cost``).  Imports nothing of JAX or goofer_tpu.
"""
from __future__ import annotations

import argparse
import gzip
import importlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

CELLS = ("note.heavy_fresh", "song.heavy_fresh")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def span_cost(n: int = 1_000_000) -> dict:
    """ns per block or call, best of 3."""
    from goofer_tpu_torch.utils import profiling

    def plain(x):
        return x

    traced = profiling.traced("cost.traced")(plain)

    def blocks():
        span = profiling.span
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with span("cost.block"):
                pass
        return (time.perf_counter_ns() - t0) / n

    def calls(fn):
        t0 = time.perf_counter_ns()
        for i in range(n):
            fn(i)
        return (time.perf_counter_ns() - t0) / n

    def phase_runs():
        phases = profiling.phases
        t0 = time.perf_counter_ns()
        for _ in range(n):
            ph = phases()
            for name in ("p.a", "p.b", "p.c", "p.d", "p.e"):
                ph.mark(name)
            ph.end()
        return (time.perf_counter_ns() - t0) / n

    def requests():
        request = profiling.request
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with request():
                pass
        return (time.perf_counter_ns() - t0) / n

    out = {}
    for on in (False, True):
        was = profiling.enable(on)
        key = "on" if on else "off"
        out[f"block_{key}_ns"] = min(blocks() for _ in range(3))
        out[f"traced_{key}_ns"] = min(calls(traced) for _ in range(3))
        out[f"phases5_{key}_ns"] = min(phase_runs() for _ in range(3))
        out[f"request_{key}_ns"] = min(requests() for _ in range(3))
        profiling.enable(was)
    out["plain_call_ns"] = min(calls(plain) for _ in range(3))
    return out


TRACED = ("features.acquire", "plan.prepare", "render.upload",
          "render.issue", "io.write", "plan.phrase", "phrase.group")
PHASES = ("plan.cut", "plan.loop", "plan.tracks", "plan.pitch",
          "plan.scalars")
# entry points a request passes: cli.main and GooferResampler.render, or
# render_phrase_to_wavs and render_phrase
ENTRIES = 2


def off_ns_per_note(spans: dict, notes: int, cost: dict, cli: bool) -> dict:
    """The off spans a request opens, by kind, and their ns a note.  A CLI
    note opens ``render.wait`` only while spans are on."""
    calls = {name: c for name, (c, _, _) in spans.items()
             if name != "request" and not (cli and name == "render.wait")}
    kinds = {"traced": sum(c for k, c in calls.items() if k in TRACED),
             "phase_runs": calls.get("plan.prepare", 0),
             "blocks": sum(c for k, c in calls.items()
                           if k not in TRACED and k not in PHASES),
             "entries": ENTRIES}
    ns = (kinds["blocks"] * cost["block_off_ns"]
          + kinds["traced"] * (cost["traced_off_ns"] - cost["plain_call_ns"])
          + kinds["phase_runs"] * cost["phases5_off_ns"]
          + kinds["entries"] * cost["request_off_ns"])
    return {"per_note": {k: v / notes for k, v in kinds.items()},
            "ns_per_note": ns / notes}


def innermost(ranges, at):
    inside = [r for r in ranges if r[0] <= at <= r[1]]
    return min(inside, key=lambda r: r[1] - r[0])[2] if inside else None


def read_trace(events, names) -> dict:
    """Idle gaps by the innermost span at their middle, device ms by the
    span whose call launched it, from a chrome trace of kineto."""
    ranges, launches, device = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args", {})
        start, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if cat == "user_annotation" and e.get("name") in names:
            ranges.append((start, end, e["name"]))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = start
        elif cat in DEVICE_CATS:
            device.append((start, end, args.get("correlation")))
    tied = [(a, b, c) for a, b, c in device if c in launches]
    launched = defaultdict(float)
    for a, b, c in tied:
        launched[innermost(ranges, launches[c]) or "outside_spans"] += (
            (b - a) / 1e3)
    idle = defaultdict(float)
    busy = 0.0
    iv = sorted((a, b) for a, b, _ in tied)
    end = None
    for a, b in iv:
        if end is not None and a > end:
            idle[innermost(ranges, (a + end) / 2) or "outside_spans"] += (
                (a - end) / 1e3)
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (iv[-1][1] - iv[0][0]) if iv else 0.0
    host = defaultdict(float)
    for a, b, name in ranges:
        host[name] += (b - a) / 1e3
    top = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1]))  # noqa
    return {"device_events": len(device), "tied": len(tied),
            "busy_ms": busy / 1e3, "window_ms": window / 1e3,
            "idle_gaps_ms": top(idle), "launched_device_ms": top(launched),
            "host_ms": top(host)}


def merge(parts: list) -> dict:
    """Sums of each number and of each dict's numbers over ``parts``."""
    out: dict = {}
    for p in parts:
        for k, v in p.items():
            if isinstance(v, dict):
                d = out.setdefault(k, {})
                for name, x in v.items():
                    d[name] = d.get(name, 0.0) + x
            else:
                out[k] = out.get(k, 0) + v
    top = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1]))  # noqa
    return {k: top(v) if isinstance(v, dict) else v for k, v in out.items()}


def run_cell(workload: str, seed: int, rounds: int, out_dir: Path,
             cost: dict, spec=None, mix=None) -> dict:
    """One cell's readings; ``spec`` and ``mix`` replace BENCHMARK.json's
    and the cell's traffic (a CPU rehearsal's tiny cell)."""
    from benchmark import harness, traffic
    from benchmark.voicebank import Voicebank
    from goofer_tpu_torch.utils import profiling

    spec = spec or harness.load_spec()
    cell, config, cell_mix = harness.cell_parts(spec, workload)
    mix = mix or cell_mix
    entry_mod = importlib.import_module(
        f"benchmark.entries.{config['entry']}")
    bank = Voicebank(config["voicebank"])
    tmp = Path(tempfile.mkdtemp(prefix="span_cost_"))
    try:
        entry = entry_mod.Entry(config, bank)
        gen = traffic.Traffic(mix, bank.aliases, bank.oto, seed)
        runner = harness.Runner(entry, mix, seed, config["sample_rate"], tmp)
        for notes in gen.warmup():
            runner.send(notes)
        harness._sync()
        window = gen.window()
        k = mix["trace_requests"]
        per_note = mix["notes_per_request"]

        # spans one request opens, per note
        was = profiling.enable(True)
        before = profiling.snapshot()
        runner.send(next(window))
        one = profiling.snapshot().since(before)
        profiling.enable(was)
        spans_per_note = sum(c for c, _, _ in one.spans.values()) / per_note

        # request ms, spans off and on, in turns
        ms = {"off": [], "on": []}
        for r in range(rounds):
            for mode in (("off", "on") if r % 2 == 0 else ("on", "off")):
                was = profiling.enable(mode == "on")
                ms[mode].append([1e3 * runner.send(next(window))[0]
                                 for _ in range(k)])
                profiling.enable(was)
        medians = {m: [statistics.median(v) for v in ms[m]] for m in ms}

        # the registry's split of the same kind of requests, no profiler
        was = profiling.enable(True)
        before = profiling.snapshot()
        for _ in range(k):
            runner.send(next(window))
        plain = profiling.snapshot().since(before)
        profiling.enable(was)
        notes = plain.counters.get("plan.notes", 0)

        # device traces of k more
        trace_dir = out_dir / f"trace_{workload}"
        if config["entry"] == "cli_note":
            os.environ["GOOFER_TPU_TRACE_DIR"] = str(trace_dir)
            try:
                for _ in range(k):
                    runner.send(next(window))
            finally:
                del os.environ["GOOFER_TPU_TRACE_DIR"]
        else:
            with profiling.device_trace(str(trace_dir)):
                for _ in range(k):
                    runner.send(next(window))
        names = set(plain.spans) | {"request"}
        files = sorted(trace_dir.glob("*.pt.trace.json"))
        traced = merge([read_trace(json.loads(f.read_text())["traceEvents"],
                                   names) for f in files])
        traced["files"] = len(files)
        with gzip.open(out_dir / f"{workload}.pt.trace.json.gz", "wb") as g:
            g.write(files[0].read_bytes())
        for f in files:
            f.unlink()
        return {
            "cell": workload, "card": card(), "seed": seed,
            "requests_per_round": k, "notes_per_request": per_note,
            "spans_per_note": spans_per_note,
            "off_spans": off_ns_per_note(one.spans, per_note, cost,
                                         workload.startswith("note.")),
            "request_ms_median_by_round": medians,
            "request_ms": ms,
            "registry_ms_per_note": {
                name: ns / 1e6 / notes
                for name, (_, ns, _) in sorted(plain.spans.items())},
            "registry_counters": plain.counters,
            "unnamed_ms_per_note": profiling.unnamed_ns(plain.records)
            / 1e6 / notes,
            "device_trace": traced,
        }
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
        bank.close()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=2**31 + 1601)
    ap.add_argument("--cells", nargs="*", default=list(CELLS))
    ap.add_argument("--out", default=str(REPO / "build" / "span_cost"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    cost = span_cost()
    cost["card"] = card()
    print(json.dumps({"span_cost": cost}), flush=True)
    (out / "span_cost.json").write_text(json.dumps(cost, indent=1))
    for i, cell in enumerate(args.cells):
        r = run_cell(cell, args.seed + i, args.rounds, out, cost)
        (out / f"{cell}.json").write_text(json.dumps(r, indent=1))
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
