"""Decoded-features memo (``sampler/resampler.py:acquire_features``),
read inside the program: ms of its ``features.acquire`` spans, a memo hit
or a load and decode, over the notes planned, in the device stretch
(progtrace.py)."""
from benchmark import progtrace

progtrace.begin()
install = progtrace.install


def read(t):
    return progtrace.per_note_ms(t, "features.acquire")
