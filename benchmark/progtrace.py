"""The program's own spans and counters (``goofer_tpu_torch/utils/
profiling.py``) over the device stretch of a ``--trace 1`` run.

The harness loads a cell's per-layer readers once the window has closed
and before the device stretch, and calls each reader's ``install(t)``
after that stretch and before the attributed one.  Each reader of the
program's registry calls ``begin`` as it loads: the first call turns the
program's spans on, and each takes the snapshot again, so the last holds
as the stretch starts.  ``install`` takes the second snapshot and turns
the spans back off, so the attributed stretch and the check run as they
did, and leaves in ``t.program`` what the device stretch recorded
(``delta``: the cell's ``trace_requests`` requests, CUDA activity only, so
no host op is recorded, though each launch runs slower under CUPTI) and
the process's totals (``total``).

Where ``install`` never runs (no CUDA), or the program has no registry (a
checkout from before it), every reader returns None.  "Per note" is over
the program's ``plan.notes`` counter: the notes handed to its planner.
"""
from __future__ import annotations

_open = None        # (registry module, its earlier setting, snapshot)


def _registry():
    try:
        from goofer_tpu_torch.utils import profiling
    except ImportError:
        return None
    needed = ("enable", "snapshot", "unnamed_ns")
    return profiling if all(hasattr(profiling, n) for n in needed) else None


def begin() -> None:
    """Spans on and the first snapshot; each reader that loads takes it
    again, so the last one before the stretch holds."""
    global _open
    prof = _registry()
    if prof is not None:
        was = prof.enable(True) if _open is None else _open[1]
        _open = (prof, was, prof.snapshot())


def _close():
    global _open
    prof, was, before = _open
    _open = None
    prof.enable(was)
    return prof, before


def install(t) -> None:
    """The second snapshot, the spans off; once a trace."""
    if _open is None or hasattr(t, "program"):
        return
    prof, before = _close()
    after = prof.snapshot()
    t.program = {"registry": prof, "delta": after.since(before),
                 "total": after}


def stretch(t):
    """``t.program``, or None; an open ``begin`` is closed."""
    if _open is not None and not hasattr(t, "program"):
        _close()
    return getattr(t, "program", None)


def _notes(t):
    prog = stretch(t)
    if prog is None:
        return None, None
    notes = prog["delta"].counters.get("plan.notes", 0)
    return (prog["delta"], notes) if notes > 0 else (None, None)


def per_note_ms(t, span: str):
    """ms inside spans ``span`` over the notes planned."""
    delta, notes = _notes(t)
    if delta is None:
        return None
    return delta.spans.get(span, (0, 0, 0))[1] / 1e6 / notes


def per_note_count(t, counter: str):
    """Counter ``counter`` over the notes planned."""
    delta, notes = _notes(t)
    if delta is None:
        return None
    return delta.counters.get(counter, 0) / notes


def unnamed_ms_per_note(t):
    """ms of the ``request`` spans that no leaf span covers, over the
    notes planned; None where the ring lost records of the stretch."""
    delta, notes = _notes(t)
    if delta is None or len(delta.records) < delta.closed:
        return None
    prof = stretch(t)["registry"]
    return prof.unnamed_ns(delta.records) / 1e6 / notes
