"""One run of one cell: the harness that ``run.py`` drives.

Everything a cell needs is found by name from ``BENCHMARK.json``: the
cell's configuration file (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``) and each per-layer metric's reader
(``metrics/<name>.py``).  A deployment is made of five parts, each a
module that the configuration or the mix names, so a new deployment is
new files only; where a file names none, the part is the note render's:

1. inputs on disk: the configuration's ``inputs`` names
   ``inputs/<name>.py``; by default ``voicebank.py``, the vendored
   recording and its ``.goofy`` under every alias;
2. requests: the mix's ``generator`` names ``generators/<name>.py``; by
   default ``traffic.py``, fresh notes drawn from the seed's streams;
3. untimed preparation: a generator with a ``prepare`` method writes the
   files each request reads, in a folder of the request's own, before
   the request's clock starts; its time counts in no metric, and the
   folder is removed once the request has been checked;
4. outputs and audio seconds: the configuration's ``entry`` names
   ``entries/<name>.py``, whose ``call`` is timed; an entry with an
   ``outputs`` method reports each item's output file and the seconds of
   audio it produced or consumed, and by default each item's WAV, larger
   than its 44-byte header, is its output and its size gives the audio;
5. the comparison: the configuration's ``comparer`` names
   ``comparers/<name>.py``; by default ``check.py``, each note against
   the plain reference; the configuration's ``limits`` name the numbers
   judged, ``failed`` always among them.  Its ``control`` puts the
   reference, one precision below the configuration's, in the program's
   place (``control.py``).

The packages' ``__init__`` modules say what each part provides.

A run builds the inputs, imports the program and warms it up on the
mix's warm-up requests (set-up), then sends requests in a closed loop
from one caller for ``seconds``.  Each request's outputs are checked on
disk and then deleted, but for a sample drawn from the seed and the
longest, which the comparer judges once the window has closed, the peak
memory has been read and the program's work is done.  With ``trace``
the spans (spans.py) record the window and two profiled stretches
follow it (devtrace.py); a preparing generator's files for them are
written before the profiler starts and removed after it stops.  Without
it, a cell whose end-to-end metrics include ``device_ms_per_note`` has
the card's own stretch follow the window, for that one number.
"""
from __future__ import annotations

import dataclasses
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

from benchmark import check, devtrace, spans, traffic, voicebank, yardstick

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


def cell_parts(spec: dict, workload: str,
               mix: dict | None = None) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic mix) of ``workload``; the mix is
    read from its file unless given."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((REPO / conf["file"]).read_text())
    if mix is None:
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
        # the window's requests: their seconds each, audio and wall seconds
        self.window = None
        self.device = None
        self.attributed = None


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


@dataclasses.dataclass
class Sent:
    """One request on its way: its index, its items' paths and, where the
    generator prepares, the folder of the files it reads."""

    index: int
    request: list
    paths: list
    folder: Path | None = None


def wav_outputs(paths: list, sample_rate: int) -> list:
    """The default outputs: the WAV at each path, if there is one, with
    the 16-bit mono audio seconds its size gives."""
    outs = []
    for p in paths:
        try:
            size = p.stat().st_size
        except FileNotFoundError:
            outs.append(None)
            continue
        outs.append((p, (size - WAV_HEADER) / 2 / sample_rate))
    return outs


class Runner:
    """Sends a cell's requests and keeps what the check needs."""

    def __init__(self, entry, mix: dict, seed: int, sample_rate: int,
                 out_dir: Path, gen=None):
        self.entry = entry
        self.mix = mix
        self.sample_rate = sample_rate
        self.out = out_dir
        self.kept_dir = out_dir / "kept"
        self.kept_dir.mkdir()
        self.check_rng = traffic.rng(seed, traffic.CHECK)
        self.prepares = getattr(gen, "prepare", None)
        if self.prepares is not None and not hasattr(entry, "outputs"):
            # the WAV rule would take the prepared inputs for outputs
            raise TypeError("a generator that prepares its requests needs "
                            "an entry with outputs(request, paths)")
        self.requests = 0
        # seconds spent preparing requests and removing what they read
        self.untimed_s = 0.0
        self.kept: list = []
        self.longest = None

    def prepare(self, request: list) -> Sent:
        """``request`` with its index and its items' paths: the WAVs a
        render writes, or the files a preparing generator writes there
        for the request to read, untimed."""
        idx = self.requests
        self.requests += 1
        if self.prepares is None:
            return Sent(idx, request, [self.out / f"{idx}_{j}.wav"
                                       for j in range(len(request))])
        t0 = time.perf_counter()
        folder = self.out / f"in_{idx}"
        folder.mkdir()
        sent = Sent(idx, request, [folder / f"{j}.wav"
                                   for j in range(len(request))], folder)
        self.prepares(request, sent.paths)
        self.untimed_s += time.perf_counter() - t0
        return sent

    def release(self, sent: Sent) -> None:
        """Remove what a preparing generator wrote for ``sent``, untimed."""
        if sent.folder is not None:
            t0 = time.perf_counter()
            shutil.rmtree(sent.folder)
            self.untimed_s += time.perf_counter() - t0

    def send(self, request: list, keep: bool = False):
        """``prepare``, ``call`` and ``release``."""
        sent = self.prepare(request)
        try:
            return self.call(sent, keep)
        finally:
            self.release(sent)

    def warm_up(self, requests: list) -> None:
        for request in requests:
            if not self.send(request)[1]:
                raise RuntimeError("a warm-up request failed")

    def outputs(self, sent: Sent) -> list:
        outputs = getattr(self.entry, "outputs", None)
        if outputs is None:
            return wav_outputs(sent.paths, self.sample_rate)
        return outputs(sent.request, sent.paths)

    def call(self, sent: Sent, keep: bool = False):
        """One request: (seconds, ok, audio seconds); its outputs deleted
        but for those the check keeps, and what it read with them; what
        else it read stays until ``release``."""
        t0 = time.perf_counter()
        try:
            ok = bool(self.entry.call(sent.request, sent.paths))
        except Exception:
            traceback.print_exc(file=sys.stderr)
            ok = False
        dt = time.perf_counter() - t0
        outs = self.outputs(sent)
        ok = ok and all(o is not None and o[1] > 0 for o in outs)
        audio_s = sum(o[1] for o in outs) if ok else 0.0
        u = self.check_rng.random(len(sent.request))
        for j, out in enumerate(outs):
            if out is None:
                continue
            path, a = out
            name = f"{sent.index}_{j}"
            rec = {"item": sent.request[j], "request": sent.request,
                   "index": j, "audio_s": a,
                   "path": self.kept_dir / f"{name}{path.suffix}",
                   "input": (self.kept_dir / f"{name}.input"
                             f"{sent.paths[j].suffix}" if sent.folder
                             else None),
                   "drawn": bool(u[j] < self.mix["check"]["keep_share"])}
            longest = keep and (self.longest is None
                                or a > self.longest["audio_s"])
            if keep and (rec["drawn"] or longest):
                path.replace(rec["path"])
                if rec["input"] is not None:
                    sent.paths[j].replace(rec["input"])
                if rec["drawn"]:
                    self.kept.append(rec)
                if longest:
                    old = self.longest
                    self.longest = rec
                    if old is not None and not old["drawn"]:
                        _unlink(old)
            else:
                path.unlink()
        return dt, ok, audio_s

    def compared(self, seed: int) -> list:
        """The records the check compares: ``compared`` of the drawn ones,
        chosen from the seed, and the longest."""
        g = traffic.rng(seed, traffic.SAMPLE)
        n = min(self.mix["check"]["compared"], len(self.kept))
        picks = [self.kept[i] for i in sorted(
            g.choice(len(self.kept), size=n, replace=False))] if n else []
        if self.longest is not None and self.longest not in picks:
            picks.append(self.longest)
        return picks


def _unlink(rec: dict) -> None:
    rec["path"].unlink()
    if rec["input"] is not None:
        rec["input"].unlink()


def part(kind: str, name: str | None, default):
    """The module ``benchmark/<kind>/<name>.py`` that a configuration or a
    mix names for one part of its deployment, or ``default`` where it
    names none."""
    if name is None:
        return default
    return importlib.import_module(f"benchmark.{kind}.{name}")


@dataclasses.dataclass
class Deployment:
    """A cell's parts, as the module's docstring numbers them: the entry
    class (4) and the modules of inputs (1), requests (2, 3) and the
    comparison (5)."""

    entry: type
    inputs: object
    generators: object
    comparer: object


def deployment(config: dict, mix: dict) -> Deployment:
    return Deployment(
        importlib.import_module(f"benchmark.entries.{config['entry']}").Entry,
        part("inputs", config.get("inputs"), voicebank),
        part("generators", mix.get("generator"), traffic),
        part("comparers", config.get("comparer"), check))


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             spec: dict | None = None, mix: dict | None = None,
             log=sys.stderr) -> dict:
    """Run ``workload`` once; returns the result line as a dict."""
    import torch

    spec = spec or load_spec()
    _, config, mix = cell_parts(spec, workload, mix)
    cuda = torch.cuda.is_available()
    parts = deployment(config, mix)
    inputs = parts.inputs.build(config)
    out_dir = Path(tempfile.mkdtemp(prefix="bench_out_"))
    t = Trace() if trace else None
    try:
        gen = parts.generators.generator(mix, inputs, seed)
        runner = Runner(parts.entry(config, inputs), mix, seed,
                        config["sample_rate"], out_dir, gen)
        runner.warm_up(gen.warmup())
        _sync()
        if t is not None:
            spans.install(t.rec)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        setup_s = process_age()

        window = gen.window()
        lat, attempted, failed, audio_s, items = [], 0, 0, 0.0, 0
        untimed_at = runner.untimed_s

        def active_s():
            return (time.perf_counter() - t_start
                    - (runner.untimed_s - untimed_at))

        t_start = time.perf_counter()
        while active_s() < seconds or not attempted:
            request = next(window)
            dt, ok, a = runner.send(request, keep=True)
            lat.append(dt)
            attempted += 1
            failed += not ok
            audio_s += a
            items += len(request)
        window_s = active_s()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        print(f"window: {attempted} requests ({items} items), {failed} "
              f"failed, {audio_s:.3f} s of audio in {window_s:.3f} s; "
              f"request median {1e3 * statistics.median(lat):.3f} ms",
              file=log)
        n_dev = mix["trace_requests"]

        def profile(stretch):
            """``stretch`` profiling the next ``n_dev`` requests, each
            drawn as the stretch comes to it, but prepared files written
            before it starts and removed after it stops; and the items
            they held."""
            sent = (runner.prepare(next(window)) for _ in range(n_dev))
            if runner.prepares is not None:
                sent = list(sent)
            done = []

            def run():
                for x in sent:
                    runner.call(x)
                    done.append(x)

            read = stretch(run)
            for x in done:
                runner.release(x)
            return read, sum(len(x.request) for x in done)

        metrics = {}
        if t is None:
            values = {
                "audio_x_realtime": audio_s / window_s,
                "note_p95_ms": 1e3 * yardstick.percentile(lat, 95.0),
                "setup_s": setup_s,
            }
            e2e = cell_metrics(spec, workload, "end_to_end")
            if cuda and any(m["name"] == "device_ms_per_note" for m in e2e):
                # the card's busy ms a note over its own stretch
                dev, notes = profile(devtrace.device_stretch)
                values["device_ms_per_note"] = 1e3 * dev["busy_s"] / notes
                print(f"device stretch: {notes} notes, {dev['busy_s']:.6f} "
                      f"s busy of {dev['window_s']:.6f} s", file=log)
            for m in e2e:
                # a device metric only where there is a device
                if m["name"] in values or m["source"] != "device_trace":
                    metrics[m["name"]] = {"value": values[m["name"]],
                                          "unit": m["unit"]}
        breakdown = None
        if t is not None:
            t.rec.active = False
            t.window = {"lat": lat, "audio_s": audio_s, "window_s": window_s}
            readers = {m["name"]: metric_reader(m["name"])
                       for m in cell_metrics(spec, workload, "per_layer")}
            if cuda:
                t.device, sent_items = profile(devtrace.device_stretch)
                # the items the stretch sent: its notes, for a render
                t.device["notes"] = sent_items
                for r in readers.values():
                    if hasattr(r, "install"):
                        r.install(t)
                t.rec.ranges = True
                t.attributed = profile(devtrace.attributed_stretch)[0]
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

        records = runner.compared(seed)
        worst = parts.comparer.worst(records, inputs, config, parts.entry,
                                     "cuda" if cuda else "cpu")
        worst["failed"] = failed
        correct, checks = check.judge(worst, config["limits"])
        print(f"compared {len(records)} items with the plain reference",
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
        inputs.close()
