"""Host planning (``sampler/resampler.py:GooferResampler.prepare``): wall
ms inside ``prepare`` calls over the notes planned (the notes handed to
the phrase planner, or one per CLI note)."""


def read(t):
    planned = t.rec.notes["plan_phrase"] or t.rec.notes["prepare"]
    if not planned:
        return None
    return 1e3 * t.rec.seconds["prepare"] / planned
