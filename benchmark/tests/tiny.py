"""A cell cut to a size the CPU runs in seconds, for the harness's tests:
two aliases, three notes of 300-350 ms a request, one warm-up request."""
from __future__ import annotations

import json
import os

from benchmark import harness


def tiny_cell(tmp_path, workload: str):
    """(spec, mix) of ``workload`` cut to the tiny size; the spec's
    configuration file is rewritten under ``tmp_path``."""
    spec = harness.load_spec()
    cell, config, mix = harness.cell_parts(spec, workload)
    config["voicebank"] = dict(config["voicebank"], aliases=2)
    path = tmp_path / f"{cell['config']}.json"
    path.write_text(json.dumps(config))
    for c in spec["configs"]:
        if c["name"] == cell["config"]:
            c["file"] = str(path)
    mix = dict(mix, length_ms=[300, 350, 50],
               notes_per_request=min(mix["notes_per_request"], 3),
               warmup_requests=2 if mix["notes_per_request"] == 1 else 1,
               trace_requests=1, check=dict(keep_share=1.0, compared=3))
    return spec, mix


def cpu_env(monkeypatch):
    """Run the program's plain versions on the CPU, one thread."""
    import torch

    monkeypatch.setenv("GOOFER_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
