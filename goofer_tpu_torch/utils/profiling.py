"""Spans and counters of the port, the per-stage profile of a note render,
and its device trace.

Port of goofer_tpu/utils/profiling.py, with the same switches, and the
port's own registry of spans and counters:

* ``span(name, notes=1)`` — context manager timing one piece of work.  A
  closed span records its name, its request id, its parent span,
  ``time.perf_counter_ns`` at start and end, the notes it covered and its
  thread, into a ring of the last ``RING_SIZE`` records and into totals by
  name (calls, ns, notes) kept apart from the ring.  Off (the default) it
  is one shared object that reads no clock and records nothing.  Spans
  are on under ``enable(True)``, in a process started with
  GOOFER_TPU_PROFILE=1 or GOOFER_TPU_TRACE_DIR, inside an enabled
  ``StageTimer``'s stages (a note render under GOOFER_TPU_PROFILE=1) and
  inside ``device_trace``.  While a ``torch.profiler`` runs, each span
  also opens a ``record_function`` range of its name, so the spans sit in
  the trace beside the kernels they launched, on the trace's clock;
* ``request(notes)`` — the span of one request at an entry point
  (``entry`` around every call of a function).  A span opened while no
  request is open starts a new request id; an entry point called inside
  another request joins it.  The process's first request is always timed,
  as ``setup.first_request``;
* ``traced(name, notes)`` — ``span`` around every call of a function;
  ``phases()`` — back-to-back leaf spans marked along straight-line code;
* ``count(name, n=1)`` — integer counters, always on;
* ``snapshot()`` — totals, counters and a copy of the ring;
  ``Snapshot.since`` takes the difference of two, ``unnamed_ns`` the time
  of requests that no innermost span names;
* ``StageTimer`` — named per-stage wall-clock accounting with an RTF
  summary (enable in the CLI with GOOFER_TPU_PROFILE=1), each stage a span
  of the registry named ``stage.<name>`` with spans on inside it.  On a
  CUDA device each stage ends with ``torch.cuda.synchronize``, so a stage
  is charged its own device work rather than the first later stage that
  waits on the device; a disabled timer reads no clock and synchronizes
  nothing;
* ``device_trace`` — context manager around ``torch.profiler`` writing a
  ``*.pt.trace.json`` that TensorBoard and Perfetto open
  (GOOFER_TPU_TRACE_DIR=/path enables it in the CLI).
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import itertools
import logging
import os
import threading
import time
from collections import deque, namedtuple
from dataclasses import dataclass, field

import torch

log = logging.getLogger("goofer_tpu_torch")

RING_SIZE = 65536

SpanRecord = namedtuple(
    "SpanRecord", "id parent request name start_ns end_ns notes thread")

_lock = threading.Lock()
_ring: deque = deque(maxlen=RING_SIZE)
_closed = 0                 # records ever put into the ring
_totals: dict = {}          # name -> [calls, ns, notes]
_counters: dict = {}
_ids = itertools.count(1)
_request = contextvars.ContextVar("goofer_tpu_torch_request", default=0)
_parent = contextvars.ContextVar("goofer_tpu_torch_span", default=0)

_explicit = False           # enable()
_scopes = 0                 # _SpansOn blocks open: stages, device traces
_first_pending = True       # no request has opened in this process yet
_ON = False


def profiling_enabled() -> bool:
    return os.environ.get("GOOFER_TPU_PROFILE", "0") not in ("", "0")


# the variables as the process started with them
_from_env = profiling_enabled() or bool(os.environ.get("GOOFER_TPU_TRACE_DIR"))


def _refresh() -> None:
    global _ON
    _ON = _explicit or _from_env or _scopes > 0


_refresh()


def enable(on: bool = True) -> bool:
    """Turn spans on or off; returns the previous setting.  The
    variables and ``device_trace`` turn them on besides."""
    global _explicit
    before, _explicit = _explicit, bool(on)
    _refresh()
    return before


def spans_enabled() -> bool:
    return _ON


class _SpansOn:
    """Spans on inside the block."""
    __slots__ = ()

    def __enter__(self):
        global _scopes
        with _lock:
            _scopes += 1
        _refresh()

    def __exit__(self, exc_type, exc, tb):
        global _scopes
        with _lock:
            _scopes -= 1
        _refresh()


def _add_total(name: str, ns: int, notes: int) -> None:
    tot = _totals.get(name)
    if tot is None:
        _totals[name] = [1, ns, notes]
    else:
        tot[0] += 1
        tot[1] += ns
        tot[2] += notes


class _NoSpan:
    """What ``span`` returns while spans are off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_NOOP = _NoSpan()


class _Span:
    __slots__ = ("name", "notes", "id", "parent", "request", "start",
                 "end", "_tokens", "_range")

    def __init__(self, name: str, notes: int = 1):
        self.name = name
        self.notes = notes

    def __enter__(self):
        self.id = next(_ids)
        self.request = _request.get()
        self.parent = _parent.get()
        request_token = None
        if not self.request:
            self.request = self.id
            request_token = _request.set(self.id)
        self._tokens = (_parent.set(self.id), request_token)
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        parent_token, request_token = self._tokens
        _parent.reset(parent_token)
        if request_token is not None:
            _request.reset(request_token)
        _record(SpanRecord(self.id, self.parent, self.request, self.name,
                           self.start, self.end, self.notes,
                           threading.get_ident()))
        return False


def _record(rec: SpanRecord) -> None:
    global _closed
    with _lock:
        _ring.append(rec)
        _closed += 1
        _add_total(rec.name, rec.end_ns - rec.start_ns, rec.notes)


class _FirstRequest(_Span):
    """The process's first request: recorded whether spans are on or
    not, and totalled again as ``setup.first_request``."""
    __slots__ = ()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        with _lock:
            _add_total("setup.first_request", self.end - self.start,
                       self.notes)
        return False


class _Phases:
    """Back-to-back leaf spans inside the current span: ``mark(name)``
    ends the running phase and starts ``name``, ``end()`` ends the last.
    A phase sets no context, so an exception only loses the open one."""
    __slots__ = ("parent", "request", "name", "start", "_range")

    def __init__(self):
        self.parent = _parent.get()
        self.request = _request.get()
        self.name = None
        self._range = None

    def mark(self, name):
        now = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self.name is not None:
            rid = next(_ids)
            _record(SpanRecord(rid, self.parent, self.request or rid,
                               self.name, self.start, now, 1,
                               threading.get_ident()))
        self.name = name
        if name is not None and torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(name)
            self._range.__enter__()
        self.start = time.perf_counter_ns()

    def end(self):
        self.mark(None)


class _NoPhases:
    """What ``phases`` returns while spans are off."""
    __slots__ = ()

    def mark(self, name):
        pass

    def end(self):
        pass


_NO_PHASES = _NoPhases()


def phases():
    """A run of back-to-back leaf spans (``_Phases``), or a shared object
    that does nothing while spans are off."""
    return _Phases() if _ON else _NO_PHASES


def span(name: str, notes: int = 1, always: bool = False):
    """Context manager recording span ``name`` over ``notes`` notes;
    ``always`` records it while spans are off too (for work that happens
    a few times a process)."""
    if _ON or always:
        return _Span(name, notes)
    return _NOOP


def request(notes: int = 1):
    """The span of one request at an entry point: a new request id, or
    nothing where a request is already open (the entry point joins it)."""
    global _first_pending
    if _request.get():
        return _NOOP
    if _first_pending:
        with _lock:
            first, _first_pending = _first_pending, False
        if first:
            return _FirstRequest("request", notes)
    return _Span("request", notes) if _ON else _NOOP


def entry(notes=None):
    """Decorator: each call is a ``request`` over ``notes(*args,
    **kwargs)`` notes (default 1), joined where one is open."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with request(1 if notes is None else notes(*args, **kwargs)):
                return fn(*args, **kwargs)
        return call
    return wrap


def traced(name: str, notes=None):
    """Decorator: each call is a span ``name``; ``notes(*args, **kwargs)``
    counts its notes (default 1)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _ON:
                return fn(*args, **kwargs)
            with _Span(name, 1 if notes is None else notes(*args, **kwargs)):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (always on)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


@dataclass
class Snapshot:
    """Totals by span name ((calls, ns, notes)), counters, and ring
    records; ``closed`` counts the records ever put into the ring."""
    spans: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    records: list = field(default_factory=list)
    closed: int = 0

    def since(self, earlier: "Snapshot") -> "Snapshot":
        """What was recorded between ``earlier`` and this snapshot (the
        records as far as the ring still holds them)."""
        spans = {}
        for name, (calls, ns, notes) in self.spans.items():
            c0, ns0, n0 = earlier.spans.get(name, (0, 0, 0))
            if calls > c0:
                spans[name] = (calls - c0, ns - ns0, notes - n0)
        counters = {k: v - earlier.counters.get(k, 0)
                    for k, v in self.counters.items()
                    if v != earlier.counters.get(k, 0)}
        new = self.closed - earlier.closed
        records = self.records[-new:] if new > 0 else []
        return Snapshot(spans, counters, records, new)


def snapshot(records: bool = True) -> Snapshot:
    """The registry now; ``records`` False leaves the ring out."""
    with _lock:
        return Snapshot({k: tuple(v) for k, v in _totals.items()},
                        dict(_counters), list(_ring) if records else [],
                        _closed)


def _union_ns(intervals) -> int:
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def unnamed_ns(records) -> int:
    """Nanoseconds of the ``request`` spans among ``records`` that no
    leaf span (one that is no record's parent) of the same request
    covers: the host time no span names."""
    parents = {r.parent for r in records}
    leaves: dict = {}
    for r in records:
        if r.id not in parents and r.name != "request":
            leaves.setdefault(r.request, []).append((r.start_ns, r.end_ns))
    total = 0
    for r in records:
        if r.name == "request":
            inside = [(max(a, r.start_ns), min(b, r.end_ns))
                      for a, b in leaves.get(r.request, ())
                      if b > r.start_ns and a < r.end_ns]
            total += r.end_ns - r.start_ns - _union_ns(inside)
    return total


def span_report(snap: Snapshot) -> str:
    """One line per span name and per counter of ``snap``."""
    lines = [f"[spans] {sum(c for c, _, _ in snap.spans.values())} spans, "
             f"{len(snap.counters)} counters"]
    for name, (calls, ns, notes) in sorted(snap.spans.items()):
        lines.append(f"  {name:<24s} {ns / 1e6:9.2f} ms "
                     f"(n={calls}, notes={notes})")
    for name, n in sorted(snap.counters.items()):
        lines.append(f"  {name:<24s} {n}")
    return "\n".join(lines)


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
        s = _Span(f"stage.{name}")
        try:
            with _SpansOn(), s:
                try:
                    yield
                finally:
                    if self.device is not None and self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
        finally:
            dt = (s.end - s.start) / 1e9
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
    """torch.profiler trace (host ops, the port's spans, and the CUDA
    kernels whenever CUDA is available) into ``trace_dir`` or
    $GOOFER_TPU_TRACE_DIR if either is set, else no-op.  ``device``: the
    render's device (see ``profiled``)."""
    trace_dir = trace_dir or os.environ.get("GOOFER_TPU_TRACE_DIR")
    if not trace_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with _SpansOn(), profiled(
            activities, device,
            torch.profiler.tensorboard_trace_handler(trace_dir)):
        yield
    log.info("[profile] device trace written to %s", trace_dir)
