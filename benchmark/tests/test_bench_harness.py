"""The harness: BENCHMARK.json within its contract, every piece found by
name, the result line's form, no card no result, no JAX loaded, and
``correct`` false whenever the timed path is broken underneath.

The runs here skip the harness's look for a card and drive the rest of a
run on the CPU at a tiny size (tiny.py), the program on its plain
versions."""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import harness
from benchmark.tests.tiny import cpu_env, tiny_cell

REPO = harness.REPO
CELLS = ("song.heavy_fresh", "note.heavy_fresh")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    return harness.load_spec()


def test_benchmark_json_keys_and_names():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["benchmark"]
    assert 1 <= s["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in s[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        conf = json.loads((REPO / c["file"]).read_text())
        assert all(k in conf or k in conf["assumed"] for k in c["reduced"])
        assert conf["reduced"] == c["reduced"]
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= {w["name"]
                                               for w in s["workloads"]}
    e2e = {m["name"] for m in s["end_to_end"]}
    assert "setup_s" in e2e
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        # every cell that reads it reports the metric it moves
        for w in m["workloads"]:
            assert m["moves"] in {x["name"] for x in harness.cell_metrics(
                s, w, "end_to_end")}, (m["name"], w)


@pytest.mark.parametrize("workload", CELLS)
def test_every_piece_found_by_name(workload):
    s = spec()
    cell, config, mix = harness.cell_parts(s, workload)
    assert (harness.HERE / "entries" / f"{config['entry']}.py").is_file()
    assert mix["notes_per_request"] >= 1
    for kind in ("end_to_end", "per_layer"):
        assert harness.cell_metrics(s, workload, kind)
    for m in harness.cell_metrics(s, workload, "per_layer"):
        assert hasattr(harness.metric_reader(m["name"]), "read")


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.cell_parts(spec(), "no.such_cell")


@pytest.mark.parametrize("workload", CELLS)
def test_result_line_follows_the_contract(workload, tmp_path, monkeypatch):
    cpu_env(monkeypatch)
    s, mix = tiny_cell(tmp_path, workload)
    r = harness.run_cell(workload, 2**31 + 9, 0.0, False, spec=s, mix=mix)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    # on the CPU there is no device to read a device metric from
    want = {m["name"] for m in harness.cell_metrics(s, workload,
                                                    "end_to_end")
            if m["source"] != "device_trace"}
    assert set(r["metrics"]) == want
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r, allow_nan=False)


def test_traced_line_carries_the_span_metrics(tmp_path, monkeypatch):
    cpu_env(monkeypatch)
    s, mix = tiny_cell(tmp_path, "song.heavy_fresh")
    r = harness.run_cell("song.heavy_fresh", 3, 0.0, True, spec=s, mix=mix)
    assert r["correct"] is True
    assert r["metrics"]["plan.memo_hit_share"]["value"] == 0.0
    for name in ("plan.host_ms_per_note", "render.issue_ms_per_note",
                 "io.write_ms_per_note", "phrase.notes_per_pass",
                 "features.acquire_ms_per_note"):
        assert r["metrics"][name]["value"] > 0
    # both aliases stay decoded after the warm-up
    assert r["metrics"]["features.loads_per_note"]["value"] == 0.0


def test_traced_note_line_carries_its_window(tmp_path, monkeypatch):
    cpu_env(monkeypatch)
    s, mix = tiny_cell(tmp_path, "note.heavy_fresh")
    r = harness.run_cell("note.heavy_fresh", 5, 0.0, True, spec=s, mix=mix)
    assert r["correct"] is True
    m = r["metrics"]
    assert m["audio_x_realtime.cli"]["value"] > 0
    assert m["note_p95_ms.cli"]["value"] > 0
    for name in ("plan.host_ms_per_note.cli", "render.issue_ms_per_note.cli",
                 "io.write_ms_per_note.cli"):
        assert m[name]["value"] > 0
    # the song's names are not the note cell's
    assert "plan.host_ms_per_note" not in m


def run_script(*args, cwd=REPO):
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = run_script("--workload", "note.heavy_fresh", "--seed", "1",
                   "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run_script("--workload", "note.heavy_fresh", "--seed", "1",
                   "--seconds", "1", "--trace", "0", cwd=tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_a_run_loads_no_jax(tmp_path):
    """In a process of its own: a tiny run on the CPU, then the top-level
    names of every loaded module, compared whole."""
    code = f"""
import json, os, sys
os.environ["GOOFER_TPU_TORCH_DEVICE"] = "cpu"
sys.path.insert(0, {str(REPO)!r})
import torch
torch.cuda.is_available = lambda: False
from benchmark import harness
from benchmark.tests.tiny import tiny_cell
from pathlib import Path

spec, mix = tiny_cell(Path({str(tmp_path)!r}), "note.heavy_fresh")
r = harness.run_cell("note.heavy_fresh", 5, 0.0, False, spec=spec, mix=mix)
print(json.dumps({{"correct": r["correct"],
                   "found": harness.forbidden_modules(),
                   "port": "goofer_tpu_torch" in sys.modules}}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out == {"correct": True, "found": [], "port": True}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "goofer_tpu_torch_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "goofer_tpu.config", sys)
    assert harness.forbidden_modules() == ["goofer_tpu"]


# ---- the timed path broken underneath: correct must read false ------

def altered(fn, change):
    def wrapper(*a, **k):
        return change(fn(*a, **k))
    return wrapper


def phrase_faults():
    from goofer_tpu_torch.sampler import phrase

    def scale_first(out):             # an answer altered where produced
        out = out.clone()
        out[0] = (out[0].float() * 0.9).to(out.dtype)
        return out

    def drop_half(out):               # half of the batch left out
        out = out.clone()
        out[out.shape[0] // 2:] = 0
        return out

    return {
        "answer_altered": (phrase, "render_group",
                           altered(phrase.render_group, scale_first)),
        "half_left_out": (phrase, "render_group",
                          altered(phrase.render_group, drop_half)),
        "answer_missing": (phrase, "write_wav", lambda *a, **k: None),
    }


def cli_faults():
    from goofer_tpu_torch.sampler import resampler

    def initial_state(out):           # a step returning its state unchanged
        return out.new_zeros(4410)

    return {
        "answer_altered": (resampler.GooferResampler, "resample",
                           altered(resampler.GooferResampler.resample,
                                   lambda out: out * 0.9)),
        "state_unchanged": (resampler.GooferResampler, "resample",
                            altered(resampler.GooferResampler.resample,
                                    initial_state)),
        "answer_missing": (resampler, "write_wav", lambda *a, **k: None),
    }


# the number each fault has to push past its limit
CAUGHT_BY = {"answer_altered": "rms_gap", "half_left_out": "rms_gap",
             "state_unchanged": "length_gap", "answer_missing": "failed"}


@pytest.mark.parametrize("workload,fault", [
    ("song.heavy_fresh", "answer_altered"),
    ("song.heavy_fresh", "half_left_out"),
    ("song.heavy_fresh", "answer_missing"),
    ("note.heavy_fresh", "answer_altered"),
    ("note.heavy_fresh", "state_unchanged"),
    ("note.heavy_fresh", "answer_missing"),
])
def test_a_broken_timed_path_is_not_correct(workload, fault, tmp_path,
                                            monkeypatch):
    cpu_env(monkeypatch)
    s, mix = tiny_cell(tmp_path, workload)
    faults = phrase_faults() if workload.startswith("song") else cli_faults()
    warmed = []

    real_window = harness.traffic.Traffic.window

    def window(self):
        # break the path once the warm-up has passed
        owner, attr, fn = faults[fault]
        monkeypatch.setattr(owner, attr, fn)
        warmed.append(True)
        yield from real_window(self)

    monkeypatch.setattr(harness.traffic.Traffic, "window", window)
    r = harness.run_cell(workload, 17, 0.0, False, spec=s, mix=mix)
    assert warmed
    assert r["correct"] is False, r["checks"]
    c = r["checks"][CAUGHT_BY[fault]]
    assert c["value"] > c["limit"], r["checks"]


def test_reference_agrees_with_the_program_on_a_cli_note(tmp_path,
                                                         monkeypatch):
    """The repository's own plain paths: a note through
    goofer_tpu_torch.cli on the CPU equals the reference's, sample for
    sample."""
    from scipy.io import wavfile

    from benchmark.reference import note
    from benchmark.voicebank import SOURCE_GOOFY, SOURCE_WAV
    from goofer_tpu_torch import cli

    cpu_env(monkeypatch)
    wav = tmp_path / "ka.wav"
    wav.write_bytes(SOURCE_WAV.read_bytes())
    (tmp_path / "ka_features.goofy").write_bytes(SOURCE_GOOFY.read_bytes())
    args = ["D4", "100", "sh30sr30sg40su40sj20st-30vf40es30pd40fw20fsta50t-7",
            "0", "350", "90", "0", "100", "0", "!120", "/M#3#AA"]
    assert cli.main([str(wav), str(tmp_path / "out.wav"), *args]) == 0
    _, got = wavfile.read(tmp_path / "out.wav")
    voice = note.load_voice(tmp_path / "ka_features.goofy", "cpu")
    want = note.pcm16_codec(note.render(voice, args, 0, "cpu"))
    assert np.array_equal(got, want)
