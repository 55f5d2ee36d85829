"""Decoded-features memo (``sampler/resampler.py:acquire_features``):
wall ms inside ``acquire_features`` calls, a memo hit or a load and
decode of the alias's ``.goofy``, over the notes planned."""


def read(t):
    planned = t.rec.notes["plan_phrase"] or t.rec.notes["prepare"]
    if not planned:
        return None
    return 1e3 * t.rec.seconds["acquire_features"] / planned
