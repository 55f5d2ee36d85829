"""Decoded-features memo (``sampler/resampler.py:_decoded_cache``), read
inside the program: its ``features.memo.miss`` counter, each a load and a
decode on the device, over the notes planned, in the device stretch
(progtrace.py).  0 where every alias stays decoded."""
from benchmark import progtrace

progtrace.begin()
install = progtrace.install


def read(t):
    return progtrace.per_note_count(t, "features.memo.miss")
