"""The request, read inside the program: ms of its ``request`` spans
that no leaf span covers (``utils/profiling.py:unnamed_ns``), the host
time no span names, over the notes planned, in the device stretch
(progtrace.py)."""
from benchmark import progtrace

progtrace.begin()
install = progtrace.install


def read(t):
    return progtrace.unnamed_ms_per_note(t)
