"""The device: 1 - (union of its events' intervals / the profiled
stretch's wall seconds), in percent."""


def read(t):
    if not t.device or t.device["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t.device["busy_s"] / t.device["window_s"])
