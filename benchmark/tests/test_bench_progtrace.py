"""The readers of the program's own spans and counters (progtrace.py):
they read the device stretch alone, between the snapshot taken as they
load and the one ``install`` takes, and nothing on the CPU or from a
program without the registry.  The CPU tests stand in for the device
stretch with the cell's requests at a tiny size (tiny.py); the card test
runs the tiny cell through the harness."""
from __future__ import annotations

import importlib

import pytest

from benchmark import harness, progtrace, traffic
from benchmark.tests.tiny import cpu_env, tiny_cell
from benchmark.voicebank import Voicebank

CELLS = ("song.heavy_fresh", "note.heavy_fresh")
NEW = ("plan.prepare_ms_per_note", "plan.memo_hit_pct",
       "features.memo_ms_per_note", "features.misses_per_note",
       "phrase.notes_per_group", "render.enqueue_ms_per_note",
       "io.wav_ms_per_note", "render.upload_ms_per_note",
       "render.wait_ms_per_note", "host.unnamed_ms_per_note",
       "setup.first_request_ms")


@pytest.fixture(autouse=True)
def no_open_stretch():
    """A reader loaded without a read (another test's) leaves its snapshot
    open and the program's spans on: close it before and after."""
    def close():
        if progtrace._open is not None:
            progtrace._close()

    close()
    yield
    close()


def base_name(name: str) -> str:
    """The metric that ``name`` reads: the per-note cell's twins end in
    ``.cli``."""
    return name[:-len(".cli")] if name.endswith(".cli") else name


def cell_names(spec, workload):
    return [m["name"] for m in harness.cell_metrics(spec, workload,
                                                    "per_layer")
            if base_name(m["name"]) in NEW]


def test_every_program_metric_has_its_entry():
    spec = harness.load_spec()
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["source"] in ("program_span", "program_counter")
        assert m["moves"] == ("setup_s" if name.startswith("setup.")
                              else "audio_x_realtime")
    for name in cell_names(spec, "note.heavy_fresh"):
        m = entries[name]
        assert m["source"] == entries[base_name(name)]["source"]
        assert m["moves"] == ("setup_s" if name.startswith("setup.")
                              else "device_ms_per_note")
    assert {base_name(n) for n in cell_names(spec, "note.heavy_fresh")} == (
        set(NEW) - {"plan.memo_hit_pct", "phrase.notes_per_group"})
    assert set(cell_names(spec, "song.heavy_fresh")) == set(NEW)


@pytest.mark.parametrize("registry", [True, False],
                         ids=["cpu", "no_registry"])
def test_traced_cpu_run_reads_nothing(tmp_path, monkeypatch, registry):
    """On the CPU ``install`` never runs: every reader returns None and
    the program's spans are off again after the run."""
    from goofer_tpu_torch.utils import profiling

    cpu_env(monkeypatch)
    if not registry:
        monkeypatch.setattr(progtrace, "_registry", lambda: None)
    s, mix = tiny_cell(tmp_path, "song.heavy_fresh")
    r = harness.run_cell("song.heavy_fresh", 2**31 + 21, 0.0, True, spec=s,
                         mix=mix)
    assert r["correct"] is True
    assert not set(NEW) & set(r["metrics"])
    assert not profiling.spans_enabled()


def _stand_in_stretch(tmp_path, workload, seed):
    """The harness's order on the CPU: warm-up, the readers load, the
    stretch's requests, ``install``, one more request (the attributed
    stretch), then the reads."""
    s, mix = tiny_cell(tmp_path, workload)
    cell, config, _ = harness.cell_parts(s, workload)
    entry_mod = importlib.import_module(
        f"benchmark.entries.{config['entry']}")
    bank = Voicebank(config["voicebank"])
    try:
        entry = entry_mod.Entry(config, bank)
        gen = traffic.Traffic(mix, bank.aliases, bank.oto, seed)
        out = tmp_path / "out"
        out.mkdir()
        runner = harness.Runner(entry, mix, seed, config["sample_rate"], out)
        for notes in gen.warmup():
            assert runner.send(notes)[1]
        window = gen.window()
        t = harness.Trace()
        readers = {n: harness.metric_reader(n) for n in cell_names(s,
                                                                   workload)}
        for _ in range(mix["trace_requests"]):
            runner.send(next(window))
        for r in readers.values():
            r.install(t)
        runner.send(next(window))
        return mix, t, {base_name(n): r.read(t)
                        for n, r in readers.items()}
    finally:
        bank.close()


@pytest.mark.parametrize("workload", CELLS)
def test_readers_read_the_stretch_alone(tmp_path, monkeypatch, workload):
    from goofer_tpu_torch.utils import profiling

    cpu_env(monkeypatch)
    mix, t, values = _stand_in_stretch(tmp_path, workload, 2**31 + 23)
    delta = t.program["delta"]
    assert delta.counters["plan.notes"] == (mix["trace_requests"]
                                            * mix["notes_per_request"])
    assert delta.spans["request"][0] == mix["trace_requests"]
    assert all(v is not None and v >= 0 for v in values.values()), values
    assert 0 < values["plan.prepare_ms_per_note"]
    assert values["host.unnamed_ms_per_note"] < (
        delta.spans["request"][1] / 1e6 / delta.counters["plan.notes"])
    assert not profiling.spans_enabled()


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_card_tiny_cell_reads_its_stretch(tmp_path, monkeypatch, workload):
    """On the card: the tiny cell's traced run reads every program metric,
    and the snapshots hold the device stretch's notes exactly."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    seen = []
    real = progtrace.install

    def install(t):
        real(t)
        seen.append(t)

    monkeypatch.setattr(progtrace, "install", install)
    s, mix = tiny_cell(tmp_path, workload)
    r = harness.run_cell(workload, 2**31 + 25, 1.0, True, spec=s, mix=mix)
    assert r["correct"] is True
    assert set(cell_names(s, workload)) <= set(r["metrics"])
    delta = seen[0].program["delta"]
    assert delta.counters["plan.notes"] == (mix["trace_requests"]
                                            * mix["notes_per_request"])
