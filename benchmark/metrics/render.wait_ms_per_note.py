"""The host blocked on the device, read inside the program: ms of its
``render.wait`` spans (the note's stream synchronized ahead of its copy,
a phrase's ``synchronize``) over the notes planned, in the device stretch
(progtrace.py)."""
from benchmark import progtrace

progtrace.begin()
install = progtrace.install


def read(t):
    return progtrace.per_note_ms(t, "render.wait")
