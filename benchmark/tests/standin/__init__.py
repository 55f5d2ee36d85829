"""A deployment that is not a note render, for the harness's tests only
and never in BENCHMARK.json: folder-mode analysis of fresh cuts of a
pool of recordings, each request a folder of WAV cuts written before its
clock starts, each cut analysed into a ``<stem>_rms.npy`` of frame RMS.

Every part is a module of this package, found by the names its
configuration and mix give once ``register`` has put them where the
harness looks (``benchmark.<kind>.standin``)."""
from __future__ import annotations

import json
import sys

from benchmark import harness

WORKLOAD = "standin.cuts"
PARTS = {"inputs": "inputs", "generators": "generator",
         "entries": "entry", "comparers": "comparer"}
CONFIG = {
    "entry": "standin", "inputs": "standin", "comparer": "standin",
    "sample_rate": 44100, "frame": 512, "pool": {"recordings": 3},
    "precision": "float32",
    "limits": {"failed": 0, "rms_frame_gap": 1e-4},
}
MIX = {
    "generator": "standin", "cuts_per_request": 3, "cut_ms": [400, 2000],
    "warmup_requests": 1, "trace_requests": 1, "prepare_s": 0.3,
    "check": {"keep_share": 1.0, "compared": 3},
}


def register(monkeypatch) -> None:
    """Each part under the name the harness imports."""
    import importlib

    for kind, mod in PARTS.items():
        monkeypatch.setitem(
            sys.modules, f"benchmark.{kind}.standin",
            importlib.import_module(f"benchmark.tests.standin.{mod}"))


def standin_cell(tmp_path, monkeypatch):
    """(spec, mix): BENCHMARK.json with the stand-in's configuration and
    cell added, its latency reported too, and the parts registered."""
    register(monkeypatch)
    spec = harness.load_spec()
    path = tmp_path / "standin.json"
    path.write_text(json.dumps(CONFIG))
    spec["configs"].append({"name": "standin", "source": "a test",
                            "file": str(path), "reduced": [],
                            "why": "a deployment that is not a note render"})
    spec["workloads"].append({"name": WORKLOAD, "config": "standin",
                              "traffic": "standin", "chips": 1,
                              "why": "fresh cuts analysed, a folder a call"})
    for m in spec["end_to_end"]:
        if "workloads" in m and m["source"] == "host_clock":
            m["workloads"].append(WORKLOAD)
    spec["end_to_end"].append({"name": "note_p95_ms", "unit": "ms",
                               "better": "lower", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": [WORKLOAD]})
    return spec, json.loads(json.dumps(MIX))
