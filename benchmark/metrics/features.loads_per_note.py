"""Decoded-features memo (``sampler/resampler.py:_decoded_cache``):
``.goofy`` loads, each a memo miss decoded on the device, over the notes
planned. 0 where every alias stays decoded."""


def read(t):
    planned = t.rec.notes["plan_phrase"] or t.rec.notes["prepare"]
    if not planned:
        return None
    return t.rec.calls["load_features"] / planned
