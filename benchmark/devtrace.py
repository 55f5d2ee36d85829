"""The device trace of a ``--trace 1`` run, read with ``torch.profiler``.

Two profiled stretches follow the measured window, each over a fixed
number of the cell's requests:

- the device's own (CUDA activity only, the host unslowed): busy
  seconds as the union of the device events' spans, the stretch's wall
  seconds, device kernels, and the device operations that took most time;
- the attributed one (CPU and CUDA activity): every span of spans.py and
  every op-level range a metric installs opens a ``record_function``
  range, and each device kernel counts toward the range whose call
  launched it; the idle gaps are labelled with the innermost span the
  host was in.

Each starts its tracing one discarded step ahead: CUPTI can miss the
first kernels after tracing starts.  Copied from chip_smoke.py's
``device_profile`` and ``device_busy``.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

from benchmark import yardstick


@contextlib.contextmanager
def profiled(activities):
    import torch

    with torch.profiler.profile(
            activities=activities,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                             repeat=1)) as prof:
        torch.zeros(1, device="cuda").add_(1.0)
        torch.cuda.synchronize()
        prof.step()
        try:
            yield prof
        finally:
            torch.cuda.synchronize()


def _is_device(e) -> bool:
    import torch

    return e.device_type == torch.autograd.DeviceType.CUDA


def device_stretch(run) -> dict:
    """Profile the device alone over ``run()``: busy and window seconds,
    kernels, and the ten device operations with the most seconds."""
    import torch

    with profiled([torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if _is_device(e)]
    if not events:
        raise RuntimeError("torch.profiler recorded no device activity")
    busy_us = yardstick.union_length(
        (e.time_range.start, e.time_range.end) for e in events)
    by_name = defaultdict(float)
    for e in events:
        by_name[e.name] += e.time_range.elapsed_us() / 1e6
    kernels = [e for e in events
               if not e.name.startswith(("Memcpy", "Memset"))]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_us / 1e6, "window_s": wall,
            "kernels": len(kernels), "device_ops": [[k, v] for k, v in top]}


def _innermost(spans, at: int):
    """The shortest (start, end, name) of ``spans`` holding ``at``."""
    inside = [s for s in spans if s[0] <= at <= s[1]]
    return min(inside, key=lambda s: s[1] - s[0])[2] if inside else None


def attributed_stretch(run) -> dict:
    """Profile host and device over ``run()``: device seconds launched
    under each ``bench.op.<kind>`` range, by kind, and the device's idle
    gaps summed by the innermost ``bench.<span>`` range the host was in
    (``outside_spans`` where it was in none).

    A device kernel, copy or memset is tied to its launch on the host by
    the CUDA correlation id it shares with the CUDA API call that launched
    it; the launch's time and thread place it in a range.  The
    gaps are those between the tied device events."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with profiled(acts) as prof:
        run()
    events = prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    dev, ops, spans = [], defaultdict(list), defaultdict(list)
    launches = {}
    for e in events:
        if e.device_type() != cpu:
            dev.append(e)
            continue
        name = e.name()
        if e.is_user_annotation() and name.startswith("bench."):
            span = (e.start_ns(), e.end_ns(), name[len("bench."):])
            kind = "ops" if name.startswith("bench.op.") else "spans"
            (ops if kind == "ops" else spans)[e.start_thread_id()].append(
                (span[0], span[1], span[2][len("op."):] if kind == "ops"
                 else span[2]))
        elif name.startswith(("cuda", "cu")) and e.correlation_id() > 0:
            launches[e.correlation_id()] = e
    op_s = defaultdict(float)
    intervals = []
    for d in dev:
        launch = launches.get(d.correlation_id())
        if launch is None:
            continue
        intervals.append((d.start_ns(), d.start_ns() + d.duration_ns()))
        kind = _innermost(ops[launch.start_thread_id()], launch.start_ns())
        if kind is not None:
            op_s[kind] += d.duration_ns() / 1e9
    tied = len(intervals)
    host = max(spans.values(), key=len) if spans else []
    idle = defaultdict(float)
    if intervals:
        lo = min(a for a, _ in intervals)
        hi = max(b for _, b in intervals)
        for a, b in yardstick.gaps(intervals, lo, hi):
            label = _innermost(host, (a + b) // 2) or "outside_spans"
            idle[label] += (b - a) / 1e9
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"op_device_s": dict(op_s), "device_events": len(dev),
            "tied": tied, "idle_gaps": [[k, v] for k, v in gaps]}
