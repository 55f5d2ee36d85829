"""The note render's inputs (``sampler/render_core.py:device_inputs``),
read inside the program: host ms of its ``render.upload`` spans, the
stacking and the blocking host-to-device copies, over the notes planned,
in the device stretch (progtrace.py)."""
from benchmark import progtrace

progtrace.begin()
install = progtrace.install


def read(t):
    return progtrace.per_note_ms(t, "render.upload")
