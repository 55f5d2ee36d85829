"""The note render (``sampler/render_core.py:render_note_core``,
``engine/synth.py``): host ms inside ``render_note_core`` calls, which
only enqueue (no sync), over the notes they rendered."""


def read(t):
    notes = t.rec.notes["render_note_core"]
    if not notes:
        return None
    return 1e3 * t.rec.seconds["render_note_core"] / notes
