"""One run of one cell: the harness that ``run.py`` drives.

Everything a cell needs is found by name from ``BENCHMARK.json``: the
cell's configuration file (``configs/<config>.json``, which names its
entry, ``entries/<entry>.py``), its traffic mix
(``traffic/<traffic>.json``, read by traffic.py) and each per-layer
metric's reader (``metrics/<name>.py``).

A run builds the voicebank, imports the program and warms it up on the
mix's warm-up requests (set-up), then sends requests in a closed loop
from one caller for ``seconds``.  Each request's WAVs are checked on
disk and then deleted, but for a sample drawn from the seed and the
longest note, which the plain reference judges once the window has
closed, the peak memory has been read and the program's work is done.
With ``trace`` the spans (spans.py) record the window and two profiled
stretches follow it (devtrace.py).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
import traceback
from pathlib import Path

from benchmark import check, devtrace, spans, traffic, yardstick
from benchmark.voicebank import Voicebank

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# top-level module names the process must not hold once the window has
# closed: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "goofer_tpu")
WAV_HEADER = 44


def process_age() -> float:
    """Seconds since this process started: the boot clock now less the
    process's start in clock ticks after boot (/proc/self/stat), both
    counted from the same boot, so no wall-clock rounding enters."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return time.time() - STARTED


STARTED = time.time()


def load_spec() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def cell_parts(spec: dict, workload: str) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic mix) of ``workload``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((REPO / conf["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    return cell, config, mix


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(spec: dict, workload: str, kind: str) -> list[dict]:
    return [m for m in spec[kind]
            if workload in m.get("workloads", [workload])]


class Trace:
    """What a traced run's per-layer readers read."""

    def __init__(self):
        self.rec = spans.Recorder()
        self.device = None
        self.attributed = None


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Runner:
    """Sends a cell's requests and keeps what the check needs."""

    def __init__(self, entry, mix: dict, seed: int, sample_rate: int,
                 out_dir: Path):
        self.entry = entry
        self.mix = mix
        self.sample_rate = sample_rate
        self.out = out_dir
        self.kept_dir = out_dir / "kept"
        self.kept_dir.mkdir()
        self.check_rng = traffic.rng(seed, traffic.CHECK)
        self.requests = 0
        self.kept: list = []
        self.longest = None

    def send(self, notes: list, keep: bool = False):
        """One request: (seconds, ok, audio seconds); its WAVs deleted
        but for those the check keeps."""
        idx = self.requests
        self.requests += 1
        paths = [self.out / f"{idx}_{j}.wav" for j in range(len(notes))]
        t0 = time.perf_counter()
        try:
            ok = bool(self.entry.call(notes, paths))
        except Exception:
            traceback.print_exc(file=sys.stderr)
            ok = False
        dt = time.perf_counter() - t0
        sizes = []
        for p in paths:
            try:
                sizes.append(p.stat().st_size)
            except FileNotFoundError:
                sizes.append(None)
        ok = ok and all(s is not None and s > WAV_HEADER for s in sizes)
        audio_s = (sum(s - WAV_HEADER for s in sizes) / 2 / self.sample_rate
                   if ok else 0.0)
        u = self.check_rng.random(len(notes))
        for j, (p, s) in enumerate(zip(paths, sizes)):
            if s is None:
                continue
            rec = {"note": notes[j], "request": notes,
                   "key": self.entry.noise_key(j),
                   "path": self.kept_dir / p.name, "size": s,
                   "drawn": bool(u[j] < self.mix["check"]["keep_share"])}
            longest = keep and (self.longest is None
                                or s > self.longest["size"])
            if keep and (rec["drawn"] or longest):
                p.replace(rec["path"])
                if rec["drawn"]:
                    self.kept.append(rec)
                if longest:
                    old = self.longest
                    self.longest = rec
                    if old is not None and not old["drawn"]:
                        old["path"].unlink()
            else:
                p.unlink()
        return dt, ok, audio_s

    def compared(self, seed: int) -> list:
        """The notes the check compares: ``compared`` of the drawn ones,
        chosen from the seed, and the longest."""
        g = traffic.rng(seed, traffic.SAMPLE)
        n = min(self.mix["check"]["compared"], len(self.kept))
        picks = [self.kept[i] for i in sorted(
            g.choice(len(self.kept), size=n, replace=False))] if n else []
        if self.longest is not None and self.longest not in picks:
            picks.append(self.longest)
        return picks


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             spec: dict | None = None, mix: dict | None = None,
             log=sys.stderr) -> dict:
    """Run ``workload`` once; returns the result line as a dict."""
    import torch

    spec = spec or load_spec()
    cell, config, cell_mix = cell_parts(spec, workload)
    mix = mix or cell_mix
    cuda = torch.cuda.is_available()
    entry_mod = importlib.import_module(f"benchmark.entries.{config['entry']}")
    bank = Voicebank(config["voicebank"])
    out_dir = Path(tempfile.mkdtemp(prefix="bench_out_"))
    t = Trace() if trace else None
    try:
        entry = entry_mod.Entry(config, bank)
        gen = traffic.Traffic(mix, bank.aliases, bank.oto, seed)
        runner = Runner(entry, mix, seed, config["sample_rate"], out_dir)
        for notes in gen.warmup():
            if not runner.send(notes)[1]:
                raise RuntimeError("a warm-up request failed")
        _sync()
        if t is not None:
            spans.install(t.rec)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        setup_s = process_age()

        window = gen.window()
        lat, attempted, failed, audio_s = [], 0, 0, 0.0
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds or not attempted:
            dt, ok, a = runner.send(next(window), keep=True)
            lat.append(dt)
            attempted += 1
            failed += not ok
            audio_s += a
        window_s = time.perf_counter() - t_start
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        notes_per = mix["notes_per_request"]
        print(f"window: {attempted} requests ({attempted * notes_per} "
              f"notes), {failed} failed, {audio_s:.3f} s of audio in "
              f"{window_s:.3f} s; request median "
              f"{1e3 * statistics.median(lat):.3f} ms", file=log)

        metrics = {}
        if t is None:
            values = {
                "audio_x_realtime": audio_s / window_s,
                "note_p95_ms": 1e3 * yardstick.percentile(lat, 95.0),
                "setup_s": setup_s,
            }
            for m in cell_metrics(spec, workload, "end_to_end"):
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
        breakdown = None
        if t is not None:
            t.rec.active = False
            n_dev = mix["trace_requests"]

            def stretch():
                for _ in range(n_dev):
                    runner.send(next(window))

            readers = {m["name"]: metric_reader(m["name"])
                       for m in cell_metrics(spec, workload, "per_layer")}
            if cuda:
                t.device = devtrace.device_stretch(stretch)
                t.device["notes"] = n_dev * notes_per
                for r in readers.values():
                    if hasattr(r, "install"):
                        r.install(t)
                t.rec.ranges = True
                t.attributed = devtrace.attributed_stretch(stretch)
                t.rec.ranges = False
                breakdown = {"device_ops": t.device["device_ops"],
                             "idle_gaps": t.attributed["idle_gaps"]}
                print(f"traced: {n_dev} requests a stretch; device "
                      f"{t.device['busy_s']:.6f} s busy of "
                      f"{t.device['window_s']:.6f} s, {t.device['kernels']} "
                      f"kernels; attributed stretch: "
                      f"{t.attributed['device_events']} device events, "
                      f"{t.attributed['tied']} tied to a launch, op ranges' "
                      f"device s {t.attributed['op_device_s']}", file=log)
            t.rec.remove()
            units = {m["name"]: m["unit"] for m in spec["per_layer"]}
            for name, r in readers.items():
                v = r.read(t)
                if v is not None:
                    metrics[name] = {"value": v, "unit": units[name]}
        _sync()
        if cuda:
            torch.cuda.empty_cache()

        ref = check.Reference(bank, config, entry_mod.Entry,
                              "cuda" if cuda else "cpu")
        records = runner.compared(seed)
        worst = check.compare(records, ref, config["sample_rate"])
        worst["failed"] = failed
        correct, checks = check.judge(worst, config["limits"])
        print(f"compared {len(records)} notes with the plain reference",
              file=log)
        device = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                  "count": 1, "memory_peak_bytes": int(peak)}
        if t is not None and t.device is not None:
            device["busy_s"] = t.device["busy_s"]
            device["window_s"] = t.device["window_s"]
        result = {"correct": correct, "attempted": attempted,
                  "failed": failed, "metrics": metrics, "device": device}
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        bank.close()
