"""``plan.prepare_ms_per_note`` in the per-note cell, where it moves
``device_ms_per_note``: the same reading, under a name of its own."""
from benchmark.harness import metric_reader

_base = metric_reader("plan.prepare_ms_per_note")
read = _base.read
if hasattr(_base, "install"):
    install = _base.install
