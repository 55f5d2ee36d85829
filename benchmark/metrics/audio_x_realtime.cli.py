"""The per-note cell's seconds of audio over the window's wall seconds,
as ``audio_x_realtime`` is taken in the song cell, read from a traced
run's window (the spans on)."""


def read(t):
    w = t.window
    if not w or w["window_s"] <= 0 or w["audio_s"] <= 0:
        return None
    return w["audio_s"] / w["window_s"]
