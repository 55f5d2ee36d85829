"""The metric arithmetic: the percentile over all requests, the interval
union behind the idle share, the bytes and
operations of each op-level call, and the per-layer readers."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import harness, spans, yardstick


@pytest.mark.parametrize("n", [1, 2, 19, 20, 21, 1000])
def test_p95_over_all_requests(n):
    rng = np.random.default_rng(n)
    lat = rng.lognormal(size=n).tolist()
    assert yardstick.percentile(lat, 95.0) == pytest.approx(
        np.percentile(lat, 95.0))


def test_p95_sees_the_tail():
    lat = [10.0] * 94 + [100.0] * 6
    assert yardstick.percentile(lat, 95.0) == pytest.approx(100.0)


@pytest.mark.parametrize("intervals,union,gaps", [
    ([(0, 1), (2, 3)], 2, [(1, 2)]),
    ([(0, 2), (1, 3), (5, 6)], 4, [(3, 5)]),
    ([(0, 10), (2, 3)], 10, []),
    ([(4, 5), (0, 1)], 2, [(1, 4)]),
])
def test_interval_union_and_gaps(intervals, union, gaps):
    assert yardstick.union_length(intervals) == union
    lo = min(a for a, _ in intervals)
    hi = max(b for _, b in intervals)
    assert yardstick.gaps(intervals, lo, hi) == gaps


def test_bound_takes_the_larger_time():
    assert yardstick.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert yardstick.bound_s(0, 67e12) == pytest.approx(1.0)
    assert yardstick.bound_s(3.35e12, 134e12) == pytest.approx(2.0)


def test_work_per_call():
    # pulse: f0 and gate read, the train written, 4 bytes each
    assert yardstick.pulse_work(2, 10, True, 7, 3) == (
        4 * 3 * 20, 30 * 7 + 20 * 20 + 60 * 3)
    assert yardstick.pulse_work(2, 10, False, 0, 0)[0] == 4 * 2 * 20
    # cascade: x in and y out per row, alpha once per its rows
    assert yardstick.cascade_work(4, 100, 1, 12) == (
        4 * (800 + 100), 3 * 12 * 400)
    assert yardstick.cascade_work(4, 100, 4, 1)[0] == 4 * 1200
    # blur: in and out once, a multiply and an add per tap
    assert yardstick.blur_work(1000, 15) == (8000, 30000)


def test_live_pulse_work_counts_pairs_and_onsets():
    # two rows; onsets at 0 and 5 with periods 5 and 3 in row 0 (the
    # second pulse ends at 8), one onset at 2 with period 4 in row 1
    row = torch.tensor([[0, 0, 0, 0, 0, 1, 1, 1, 1, 1],
                        [-1, -1, 0, 0, 0, 0, 0, 0, 0, 0]])
    pos = torch.tensor([[0.0, 5.0], [2.0, 0.0]])
    t0 = torch.tensor([[5.0, 3.0], [4.0, 0.0]])
    pairs, onsets = yardstick.live_pulse_work((row, pos, t0), 2)
    assert onsets == 2 + 1
    assert pairs == 5 + 3 + 4


def test_live_pulse_work_matches_the_reference_tables():
    from benchmark.reference.ops.pulse import pulse_pass_tables

    f0 = torch.full((1, 4000), 220.0)
    tables = pulse_pass_tables(f0, None, 44100.0, 1.0, 160.0, 0.02, 1.7,
                               0.8, True, 16)
    pairs, onsets = yardstick.live_pulse_work(tables, 8)
    period = 44100.0 / 220.0
    assert abs(onsets - 4000 / period) <= 2
    # each sample lies in about one pulse, which ends within its period
    assert 0.5 * 4000 <= pairs <= 4000


def fake_trace(**calls):
    rec = spans.Recorder()
    for name, (seconds, n_calls, notes) in calls.items():
        rec.seconds[name] = seconds
        rec.calls[name] = n_calls
        rec.notes[name] = notes
    return SimpleNamespace(rec=rec, window=None, device=None,
                           attributed=None)


def read(name, t):
    return harness.metric_reader(name).read(t)


def test_span_readers():
    t = fake_trace(plan_phrase=(0.0, 2, 160), prepare=(0.8, 160, 160),
                   render_group=(0.5, 10, 160),
                   render_note_core=(0.3, 10, 160),
                   write_wav=(0.16, 160, 160),
                   acquire_features=(0.96, 200, 200),
                   load_features=(0.5, 120, 120))
    assert read("plan.host_ms_per_note", t) == pytest.approx(5.0)
    assert read("features.acquire_ms_per_note", t) == pytest.approx(6.0)
    assert read("features.loads_per_note", t) == pytest.approx(0.75)
    assert read("plan.memo_hit_share", t) == 0.0
    assert read("phrase.notes_per_pass", t) == 16.0
    assert read("render.issue_ms_per_note", t) == pytest.approx(1.875)
    assert read("io.write_ms_per_note", t) == pytest.approx(1.0)


def test_memo_hits_count_notes_planned_without_prepare():
    t = fake_trace(plan_phrase=(0.0, 1, 80), prepare=(0.1, 20, 20))
    assert read("plan.memo_hit_share", t) == pytest.approx(75.0)
    # the CLI plans without the phrase planner: one note per prepare
    t = fake_trace(prepare=(0.06, 10, 10))
    assert read("plan.host_ms_per_note", t) == pytest.approx(6.0)
    assert read("plan.memo_hit_share", t) is None
    assert read("features.loads_per_note", t) == 0.0


def test_readers_find_nothing_to_read():
    t = fake_trace()
    for name in ("plan.host_ms_per_note", "phrase.notes_per_pass",
                 "features.acquire_ms_per_note", "features.loads_per_note",
                 "render.issue_ms_per_note", "io.write_ms_per_note",
                 "ops.kernels_per_note", "device.idle_share",
                 "kernels_roofline"):
        assert read(name, t) is None, name


def test_device_readers():
    t = fake_trace()
    t.device = {"busy_s": 0.05, "window_s": 1.0, "kernels": 8600,
                "notes": 10}
    assert read("device.idle_share", t) == pytest.approx(95.0)
    assert read("ops.kernels_per_note", t) == pytest.approx(860.0)


def test_roofline_reader():
    t = fake_trace()
    x = torch.zeros(2, 1000)
    t.op_calls = [("blur", (x, np.ones(15, np.float32))),
                  ("cascade", (x, torch.zeros(1000), 12, "lowpass"))]
    bound = (yardstick.bound_s(*yardstick.blur_work(2000, 15))
             + yardstick.bound_s(*yardstick.cascade_work(2, 1000, 1, 12)))
    t.attributed = {"op_device_s": {"blur": 2 * bound, "cascade": 2 * bound}}
    assert read("kernels_roofline", t) == pytest.approx(25.0)
    t.attributed = {"op_device_s": {}}
    assert read("kernels_roofline", t) is None


def twins():
    """(twin, base) of each per-layer metric that the per-note cell reads
    under a name of its own."""
    out = []
    for m in harness.load_spec()["per_layer"]:
        n = m["name"]
        if n == "cli_kernels_roofline":
            out.append((n, "kernels_roofline"))
        elif n.endswith(".cli") and (harness.HERE / "metrics"
                                     / f"{n[:-4]}.py").is_file():
            out.append((n, n[:-4]))
    return out


@pytest.mark.parametrize("twin,base", twins())
def test_twins_read_as_their_base(twin, base):
    t = fake_trace(plan_phrase=(0.0, 2, 160), prepare=(0.8, 160, 160),
                   render_note_core=(0.3, 10, 160),
                   write_wav=(0.16, 160, 160),
                   acquire_features=(0.96, 200, 200),
                   load_features=(0.5, 120, 120))
    t.device = {"busy_s": 0.05, "window_s": 1.0, "kernels": 8600,
                "notes": 10}
    assert read(twin, t) == read(base, t)
    assert hasattr(harness.metric_reader(twin), "install") == hasattr(
        harness.metric_reader(base), "install")


def test_window_readers():
    t = fake_trace()
    assert read("audio_x_realtime.cli", t) is None
    assert read("note_p95_ms.cli", t) is None
    t.window = {"lat": [0.01] * 94 + [0.1] * 6, "audio_s": 50.0,
                "window_s": 2.0}
    assert read("audio_x_realtime.cli", t) == pytest.approx(25.0)
    assert read("note_p95_ms.cli", t) == pytest.approx(100.0)
