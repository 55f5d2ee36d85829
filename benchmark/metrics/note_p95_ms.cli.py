"""The per-note cell's 95th percentile of every request of a traced
run's window (the spans on), each from the call to its return with the
WAV on disk."""
from benchmark import yardstick


def read(t):
    w = t.window
    if not w or not w["lat"]:
        return None
    return 1e3 * yardstick.percentile(w["lat"], 95.0)
