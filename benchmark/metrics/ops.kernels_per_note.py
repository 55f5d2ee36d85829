"""The ops (``ops/*.py``): device kernels of the profiled stretch over
the notes it rendered."""


def read(t):
    if not t.device or not t.device["notes"]:
        return None
    return t.device["kernels"] / t.device["notes"]
