"""Per-stage profiling of a note render, and its device trace.

Port of goofer_tpu/utils/profiling.py, with the same switches:

* ``StageTimer`` — named per-stage wall-clock accounting with an RTF
  summary (enable in the CLI with GOOFER_TPU_PROFILE=1).  On a CUDA
  device each stage ends with ``torch.cuda.synchronize``, so a stage is
  charged its own device work rather than the first later stage that
  waits on the device; a disabled timer reads no clock and synchronizes
  nothing;
* ``device_trace`` — context manager around ``torch.profiler`` writing a
  ``*.pt.trace.json`` that TensorBoard and Perfetto open
  (GOOFER_TPU_TRACE_DIR=/path enables it in the CLI).
"""
from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

log = logging.getLogger("goofer_tpu_torch")


class StageTimer:
    """Accumulates wall-clock per named stage.

    ``device``: the device the stages run work on; a CUDA device is
    synchronized at the end of each stage before the clock is read.

    >>> timer = StageTimer(enabled=True)
    >>> with timer.stage("synthesize"):
    ...     pass
    >>> timer.report(audio_seconds=1.0)
    """

    def __init__(self, enabled: bool = True, device=None):
        self.enabled = enabled
        self.device = None if device is None else torch.device(device)
        self.totals: dict = {}
        self.counts: dict = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, audio_seconds: float | None = None) -> str:
        lines = []
        total = sum(self.totals.values())
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            share = 100.0 * t / total if total else 0.0
            lines.append(f"  {name:<24s} {t * 1e3:9.2f} ms "
                         f"({share:5.1f}%, n={self.counts[name]})")
        header = f"[profile] total {total * 1e3:.2f} ms"
        if audio_seconds and total > 0:
            header += f", {audio_seconds / total:.1f}x realtime"
        out = "\n".join([header] + lines)
        if self.enabled:
            log.info("%s", out)
        return out


def profiling_enabled() -> bool:
    return os.environ.get("GOOFER_TPU_PROFILE", "0") not in ("", "0")


@contextlib.contextmanager
def profiled(activities, device=None, on_trace_ready=None):
    """torch.profiler over the block, its tracing started one step ahead
    on a trivial kernel whose step is discarded: CUPTI can miss the first
    kernels after tracing starts (it recorded 99 of 100 launches once,
    and none once).  ``device`` is where the trivial kernel runs and
    what is synchronized before the trace stops: the current CUDA device
    when CUDA is traced and ``device`` is None or not CUDA, the CPU when
    CUDA is not traced.  Yields the profiler."""
    if torch.profiler.ProfilerActivity.CUDA not in activities:
        device = torch.device("cpu")
    elif device is None or torch.device(device).type != "cuda":
        device = torch.device("cuda")
    else:
        device = torch.device(device)

    def settle():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with torch.profiler.profile(
            activities=activities,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                             repeat=1),
            on_trace_ready=on_trace_ready) as prof:
        torch.zeros(1, device=device).add_(1.0)
        settle()
        prof.step()
        try:
            yield prof
        finally:
            settle()
            prof.step()


@contextlib.contextmanager
def device_trace(trace_dir: str | None = None, device=None):
    """torch.profiler trace (host ops, and the CUDA kernels whenever CUDA
    is available) into ``trace_dir`` or $GOOFER_TPU_TRACE_DIR if either
    is set, else no-op.  ``device``: the render's device (see
    ``profiled``)."""
    trace_dir = trace_dir or os.environ.get("GOOFER_TPU_TRACE_DIR")
    if not trace_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with profiled(activities, device,
                  torch.profiler.tensorboard_trace_handler(trace_dir)):
        yield
    log.info("[profile] device trace written to %s", trace_dir)
