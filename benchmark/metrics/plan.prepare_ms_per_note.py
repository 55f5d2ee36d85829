"""Host planning, read inside the program: ms of its ``plan.prepare``
spans (``sampler/resampler.py:GooferResampler.prepare``) over the notes
planned, in the device stretch (progtrace.py)."""
from benchmark import progtrace

progtrace.begin()
install = progtrace.install


def read(t):
    return progtrace.per_note_ms(t, "plan.prepare")
