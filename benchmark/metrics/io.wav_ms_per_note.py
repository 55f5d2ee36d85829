"""CLI and file I/O (``utils/audio_io.py:write_wav``), read inside the
program: ms of its ``io.write`` spans over the notes planned, in the
device stretch (progtrace.py)."""
from benchmark import progtrace

progtrace.begin()
install = progtrace.install


def read(t):
    return progtrace.per_note_ms(t, "io.write")
