"""Spans and counters recorded from the benchmark's own files, around the
calls into each layer of the program, in a ``--trace 1`` run.

Each wrapper is installed where its caller looks the function up (a
module global or a class attribute), so the program runs unchanged
beneath it.  A span adds its wall seconds and the notes it covered to a
total by name; ``active`` turns recording off while the device is
profiled, so that the profiler's cost does not reach the spans.  With a
profiler running, each call also opens a ``record_function`` range named
``bench.<span>``, which the device trace's reader uses to label what the
host was doing.
"""
from __future__ import annotations

import time
from collections import defaultdict


class Recorder:
    """Totals of wall seconds, calls and notes by span name."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)
        self.notes = defaultdict(int)
        self.active = True
        self.ranges = False
        self._undo = []

    def wrap(self, owner, attr: str, name: str, notes=lambda a, k, r: 1):
        """Replace ``owner.attr`` by a wrapper that records span ``name``;
        ``notes(args, kwargs, result)`` counts the notes of one call."""
        import torch

        fn = getattr(owner, attr)
        rec = self

        def wrapper(*args, **kwargs):
            if rec.ranges:
                with torch.profiler.record_function(f"bench.{name}"):
                    return fn(*args, **kwargs)
            if not rec.active:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            rec.seconds[name] += time.perf_counter() - t0
            rec.calls[name] += 1
            rec.notes[name] += notes(args, kwargs, out)
            return out

        wrapper.__wrapped__ = fn
        self.patch(owner, attr, wrapper)

    def patch(self, owner, attr: str, fn) -> None:
        """Set ``owner.attr`` to ``fn`` until ``remove``."""
        self._undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, fn)

    def remove(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()


def install(rec: Recorder) -> None:
    """The layer spans every cell's metrics read:

    - ``plan_phrase``: notes handed to the phrase planner;
    - ``prepare``: ``GooferResampler.prepare``, host planning of one note;
    - ``acquire_features``: a source's features from the decoded-features
      memo, or loaded and decoded on a miss (``load_features``: a load);
    - ``render_group``: one batched pass of a phrase, its notes;
    - ``render_note_core``: the render's enqueue, no sync, its batch;
    - ``write_wav``: one WAV written."""
    from goofer_tpu_torch.sampler import phrase, render_core, resampler

    rec.wrap(phrase, "plan_phrase", "plan_phrase",
             lambda a, k, r: len(a[0]))
    rec.wrap(resampler.GooferResampler, "prepare", "prepare")
    rec.wrap(phrase, "acquire_features", "acquire_features")
    rec.wrap(resampler, "acquire_features", "acquire_features")
    rec.wrap(resampler, "load_features", "load_features")
    rec.wrap(phrase, "render_group", "render_group",
             lambda a, k, r: len(a[1]))
    batch = lambda a, k, r: int(r.shape[0])  # noqa: E731
    rec.wrap(phrase, "render_note_core", "render_note_core", batch)
    rec.wrap(render_core, "render_note_core", "render_note_core", batch)
    rec.wrap(phrase, "write_wav", "write_wav")
    rec.wrap(resampler, "write_wav", "write_wav")
