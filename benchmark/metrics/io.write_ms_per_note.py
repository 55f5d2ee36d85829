"""CLI and file I/O (``utils/audio_io.py:write_wav``): wall ms inside
``write_wav`` over the WAVs written."""


def read(t):
    n = t.rec.calls["write_wav"]
    if not n:
        return None
    return 1e3 * t.rec.seconds["write_wav"] / n
