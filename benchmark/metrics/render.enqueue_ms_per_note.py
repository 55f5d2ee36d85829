"""The note render (``sampler/render_core.py:render_note_core``), read
inside the program: host ms of its ``render.issue`` spans, which only
enqueue, over the notes planned, in the device stretch (progtrace.py)."""
from benchmark import progtrace

progtrace.begin()
install = progtrace.install


def read(t):
    return progtrace.per_note_ms(t, "render.issue")
