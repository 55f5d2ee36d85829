"""A deployment that is not a note render runs through the harness from
new files alone (``standin/``): its inputs, requests prepared untimed,
outputs that are not WAVs with the audio they consumed, and a comparer
with a number of its own, judged against its own limit, and a control
that comes out as not correct through the same parts.  On the CPU but
for the traced run, which needs the card (marked ``cuda``; it looks for a
card itself and skips without one)."""
from __future__ import annotations

import itertools
import tempfile

import numpy as np
import pytest

from benchmark import control, harness
from benchmark.tests import standin
from benchmark.tests.standin import entry as standin_entry
from benchmark.tests.standin import generator, inputs
from benchmark.tests.tiny import cpu_env


@pytest.fixture
def cell(tmp_path, monkeypatch):
    """(spec, mix) of the stand-in, every temporary directory of the run
    under ``tmp_path / "tmp"``."""
    cpu_env(monkeypatch)
    (tmp_path / "tmp").mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    return standin.standin_cell(tmp_path, monkeypatch)


def after_warmup(monkeypatch, owner, attr, fn):
    """``owner.attr`` set to ``fn`` once the warm-up has passed."""
    gen = generator.Cuts
    real = gen.window

    def window(self):
        monkeypatch.setattr(owner, attr, fn)
        yield from real(self)

    monkeypatch.setattr(gen, "window", window)


def first_window_audio_s(mix, seed) -> float:
    pool = inputs.build(standin.CONFIG)
    try:
        gen = generator.generator(mix, pool, seed)
        gen.warmup()
        return sum(c["samples"] for c in next(gen.window())) / 44100
    finally:
        pool.close()


def test_runs_end_to_end_with_its_own_number(cell, tmp_path, monkeypatch):
    spec, mix = cell
    folders = []
    real = standin_entry.Entry.call

    def call(self, request, paths):
        # what of the run's prepared folders is on disk during a call
        folders.append(sorted(p.name for p in
                              paths[0].parent.parent.glob("in_*")))
        return real(self, request, paths)

    monkeypatch.setattr(standin_entry.Entry, "call", call)
    seed = 2**31 + 41
    r = harness.run_cell(standin.WORKLOAD, seed, 0.0, False, spec=spec,
                         mix=mix)
    assert r["correct"] is True, r["checks"]
    assert (r["attempted"], r["failed"]) == (1, 0)
    assert list(r["checks"]) == ["failed", "rms_frame_gap"]
    c = r["checks"]["rms_frame_gap"]
    assert 0 < c["value"] <= c["limit"] == 1e-4
    # the warm-up's folder was gone before the window's was written
    assert folders == [["in_0"], ["in_1"]]
    assert not list((tmp_path / "tmp").iterdir())
    # preparation pauses prepare_s a request: in no latency and not in
    # the window, whose audio over its seconds would read lower
    m = r["metrics"]
    assert set(m) == {"audio_x_realtime", "note_p95_ms", "setup_s"}
    assert m["note_p95_ms"]["value"] < 1e3 * mix["prepare_s"]
    audio_s = first_window_audio_s(mix, seed)
    assert m["audio_x_realtime"]["value"] > audio_s / mix["prepare_s"]


def test_audio_is_the_input_consumed(cell, tmp_path):
    spec, mix = cell
    pool = inputs.build(standin.CONFIG)
    out = tmp_path / "out"
    out.mkdir()
    try:
        gen = generator.generator(mix, pool, 5)
        runner = harness.Runner(standin_entry.Entry(standin.CONFIG, pool),
                                mix, 5, 44100, out, gen)
        for request in itertools.chain(gen.warmup(),
                                       itertools.islice(gen.window(), 2)):
            sent = runner.prepare(request)
            assert [p.stat().st_size for p in sent.paths] == [
                44 + 2 * c["samples"] for c in request]
            dt, ok, audio_s = runner.call(sent, keep=True)
            assert ok and dt < mix["prepare_s"]
            assert audio_s == sum(c["samples"] for c in request) / 44100
            assert sent.folder.exists()
            runner.release(sent)
            assert not sent.folder.exists()
        assert runner.untimed_s >= 3 * mix["prepare_s"]
        # every cut is drawn (keep_share 1): each kept with what it read
        assert len(runner.kept) == 9
        assert all(r["path"].is_file() and r["input"].is_file()
                   for r in runner.kept)
        assert runner.longest["audio_s"] == max(r["audio_s"]
                                                for r in runner.kept)
    finally:
        pool.close()


def test_a_preparing_generator_needs_outputs(cell, tmp_path):
    """Without ``outputs`` the WAV rule would read the prepared cuts as
    the call's audio, whatever the call did."""
    spec, mix = cell
    pool = inputs.build(standin.CONFIG)
    try:
        gen = generator.generator(mix, pool, 5)
        with pytest.raises(TypeError):
            harness.Runner(object(), mix, 5, 44100, tmp_path, gen)
    finally:
        pool.close()


def test_the_control_is_not_correct(cell, tmp_path):
    """control.py through the stand-in's own parts: the frame RMS in
    bfloat16 in the entry's place fails its limit."""
    spec, mix = cell
    r = control.control(standin.WORKLOAD, 2**31 + 59, "cpu", spec=spec,
                        mix=mix)
    assert r["correct"] is False
    assert r["items"] == mix["check"]["compared"]
    assert list(r["checks"]) == ["failed", "rms_frame_gap"]
    c = r["checks"]["rms_frame_gap"]
    assert c["value"] > 10 * c["limit"], r["checks"]
    assert r["checks"]["failed"]["value"] == 0
    assert not list((tmp_path / "tmp").iterdir())


def test_a_corrupted_output_is_not_correct(cell, monkeypatch):
    spec, mix = cell
    real = standin_entry.Entry.analyse
    after_warmup(monkeypatch, standin_entry.Entry, "analyse",
                 lambda self, x: real(self, x) * np.float32(1.01))
    r = harness.run_cell(standin.WORKLOAD, 43, 0.0, False, spec=spec,
                         mix=mix)
    assert r["correct"] is False
    c = r["checks"]["rms_frame_gap"]
    assert c["value"] > c["limit"], r["checks"]
    assert r["failed"] == 0


def _raises(self, request, paths):
    raise RuntimeError("the analysis failed")


@pytest.mark.parametrize("fault", [
    _raises, lambda self, request, paths: True], ids=["raises", "no_output"])
def test_a_failed_call_counts_in_failed(cell, tmp_path, monkeypatch, fault):
    spec, mix = cell
    after_warmup(monkeypatch, standin_entry.Entry, "call", fault)
    r = harness.run_cell(standin.WORKLOAD, 47, 0.0, False, spec=spec,
                         mix=mix)
    assert r["correct"] is False
    assert r["failed"] == r["attempted"] == 1
    assert r["checks"]["failed"] == {"value": 1, "limit": 0}
    assert not list((tmp_path / "tmp").iterdir())


@pytest.mark.cuda
def test_traced_stretch_leaves_preparation_out(tmp_path, monkeypatch):
    """On the card: the device stretch profiles the calls alone, its
    request's cuts written before it starts."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec, mix = standin.standin_cell(tmp_path, monkeypatch)
    r = harness.run_cell(standin.WORKLOAD, 2**31 + 53, 0.5, True, spec=spec,
                         mix=mix)
    assert r["correct"] is True, r["checks"]
    d = r["device"]
    assert 0 < d["busy_s"] <= d["window_s"] < mix["prepare_s"]
    assert r["breakdown"]["device_ops"]
