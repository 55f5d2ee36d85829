"""The phrase plan memo (``sampler/phrase.py:_plan_memo``): the share of
the notes handed to the phrase planner that it planned without a
``prepare`` call.  Fresh traffic reads 0."""


def read(t):
    planned = t.rec.notes["plan_phrase"]
    if not planned:
        return None
    return 100.0 * (planned - t.rec.calls["prepare"]) / planned
