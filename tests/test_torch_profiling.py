"""The port's note-render profile (utils/profiling.py) on the CPU.

The report string equals goofer_tpu's for the same totals and counts;
``GOOFER_TPU_PROFILE=1`` makes a 13-argument CLI render log the
features / resample / write split, ``GOOFER_TPU_TRACE_DIR`` leaves one
torch.profiler trace; neither changes a byte of the WAV; and no timer
synchronizes a device that is not CUDA.  Notes of 300 ms from the
vendored voice source, rendered with the kernels' plain versions."""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import logging  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
from pathlib import Path  # noqa: E402

from goofer_tpu.utils.profiling import StageTimer as JaxStageTimer  # noqa: E402
from goofer_tpu_torch import cli, config  # noqa: E402
from goofer_tpu_torch.sampler.resampler import GooferResampler  # noqa: E402
from goofer_tpu_torch.utils import profiling  # noqa: E402

VOICE = Path(__file__).parent / "golden" / "voice"
NOTE = ["C4", "100", "", "0", "300", "60", "0", "100", "0", "!120", "AA"]
STAGE_LINE = re.compile(r"^  (\w+)\s+([\d.]+) ms \(\s*[\d.]+%, n=(\d+)\)$")
VARIABLES = ("GOOFER_TPU_PROFILE", "GOOFER_TPU_TRACE_DIR")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread for this module (see
    tests/test_torch_phrase.py:one_torch_thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def src(tmp_path, monkeypatch):
    """The voice source and its cache in a fresh directory, the CPU as the
    device, neither profiling variable set."""
    monkeypatch.setenv(config.DEVICE_ENV, "cpu")
    for name in VARIABLES:
        monkeypatch.delenv(name, raising=False)
    shutil.copy(VOICE / "src.wav", tmp_path / "v.wav")
    shutil.copy(VOICE / "src_features.goofy", tmp_path / "v_features.goofy")
    return tmp_path / "v.wav"


def _render(src, out, flags=""):
    argv = [str(src), str(out)] + NOTE
    argv[4] = flags
    assert cli.main(argv) == 0
    return Path(out).read_bytes()


def _stages(text: str) -> dict:
    """{stage: n} of the last [profile] report in ``text``."""
    lines = text.splitlines()
    head = max(i for i, ln in enumerate(lines) if "[profile] total" in ln)
    out = {}
    for ln in lines[head + 1:]:
        m = STAGE_LINE.match(ln)
        if not m:
            break
        out[m.group(1)] = int(m.group(3))
    return out


@pytest.mark.parametrize("totals,counts", [
    ({}, {}),
    ({"resample": 0.0123}, {"resample": 1}),
    ({"features": 0.004, "resample": 0.25, "write": 0.0011,
      "a_very_long_stage_name_past_24": 1.5},
     {"features": 3, "resample": 2, "write": 1,
      "a_very_long_stage_name_past_24": 7}),
], ids=["none", "one", "several"])
@pytest.mark.parametrize("audio_seconds", [None, 1.0])
def test_report_matches_goofer_tpu(totals, counts, audio_seconds):
    ours, theirs = profiling.StageTimer(), JaxStageTimer()
    for timer in (ours, theirs):
        timer.totals, timer.counts = dict(totals), dict(counts)
    got = ours.report(audio_seconds=audio_seconds)
    assert got == theirs.report(audio_seconds=audio_seconds)
    assert got.startswith("[profile] total")


@pytest.mark.parametrize("value,logged", [("1", True), (None, False),
                                          ("0", False), ("", False)])
def test_cli_logs_stage_report(src, tmp_path, monkeypatch, caplog, value,
                               logged):
    if value is not None:
        monkeypatch.setenv("GOOFER_TPU_PROFILE", value)
    caplog.set_level(logging.INFO, logger="goofer_tpu_torch")
    _render(src, tmp_path / "out.wav")
    profile = [r.getMessage() for r in caplog.records
               if r.getMessage().startswith("[profile]")]
    if not logged:
        assert profile == []
        return
    assert len(profile) == 1
    header = profile[0].splitlines()[0]
    assert header.startswith("[profile] total ") and header.endswith(
        "x realtime")
    assert _stages(profile[0]) == {"features": 1, "resample": 1, "write": 1}


@pytest.mark.parametrize("flags", ["", "sh30sr30B20"])
def test_profiled_wav_is_byte_equal(src, tmp_path, monkeypatch, flags):
    plain = _render(src, tmp_path / "plain.wav", flags)
    monkeypatch.setenv("GOOFER_TPU_PROFILE", "1")
    monkeypatch.setenv("GOOFER_TPU_TRACE_DIR", str(tmp_path / "trace"))
    assert _render(src, tmp_path / "profiled.wav", flags) == plain


def test_trace_dir_gets_one_trace(src, tmp_path, monkeypatch, caplog):
    trace = tmp_path / "trace"
    monkeypatch.setenv("GOOFER_TPU_TRACE_DIR", str(trace))
    caplog.set_level(logging.INFO, logger="goofer_tpu_torch")
    _render(src, tmp_path / "out.wav")
    files = sorted(trace.glob("*.pt.trace.json"))
    assert len(files) == 1 and sorted(trace.iterdir()) == files
    events = json.loads(files[0].read_text())["traceEvents"]
    assert events
    # the render's own ops are in it, not only the discarded warm-up step
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert f"[profile] device trace written to {trace}" in caplog.text


def test_no_trace_without_dir(src, tmp_path, monkeypatch):
    """Unset, device_trace starts no profiler and writes nothing."""
    def no_profiler(*args, **kwargs):
        raise AssertionError("torch.profiler started")

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.profiler, "profile", no_profiler)
    before = sorted(tmp_path.rglob("*"))
    _render(src, tmp_path / "out.wav")
    assert sorted(tmp_path.rglob("*")) == sorted(
        before + [tmp_path / "out.wav"])


def _count_syncs(monkeypatch) -> list:
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    return calls


@pytest.mark.parametrize("enabled,device", [(False, None), (False, "cuda"),
                                            (True, None), (True, "cpu")])
def test_timer_synchronizes_only_cuda(monkeypatch, enabled, device):
    """A disabled timer, and an enabled one off CUDA, never synchronize;
    an enabled timer on a CUDA device synchronizes it once per stage."""
    calls = _count_syncs(monkeypatch)
    timer = profiling.StageTimer(enabled=enabled, device=device)
    for name in ("features", "resample", "write"):
        with timer.stage(name):
            pass
    assert calls == []
    assert sorted(timer.counts) == (
        ["features", "resample", "write"] if enabled else [])
    cuda = profiling.StageTimer(enabled=True, device="cuda:0")
    with cuda.stage("resample"):
        pass
    assert calls == [torch.device("cuda:0")]


def test_cpu_render_never_synchronizes(src, tmp_path, monkeypatch):
    calls = _count_syncs(monkeypatch)
    monkeypatch.setenv("GOOFER_TPU_PROFILE", "1")
    GooferResampler(src, tmp_path / "out.wav", *NOTE)
    assert calls == []


# --- the registry of spans and counters ---------------------------------

HEAVY = "sh30sr30sg40su40sj20st-30vf40es30pd40fw20fsta50"


@pytest.fixture
def spans_on():
    """Spans on for the test, the earlier setting back after it."""
    was = profiling.enable(True)
    yield
    profiling.enable(was)


@pytest.fixture
def spans_off(monkeypatch):
    """Spans off, and no first request left to time: nothing may record.
    A later ``request`` reads the (unset) variables again."""
    monkeypatch.setattr(profiling, "_from_env", False)
    monkeypatch.setattr(profiling, "_first_pending", False)
    was = profiling.enable(False)
    yield
    profiling.enable(was)


def _since(before):
    return profiling.snapshot().since(before)


def test_spans_off_read_no_clock_and_record_nothing(src, spans_off,
                                                    monkeypatch, tmp_path):
    def no_clock():
        raise AssertionError("a span read the clock")

    @profiling.traced("test.traced")
    def work(x):
        return x + 1

    before = profiling.snapshot()
    monkeypatch.setattr(profiling.time, "perf_counter_ns", no_clock)
    assert not profiling.spans_enabled()
    first = profiling.span("test.a")
    with first, profiling.span("test.b", notes=3), profiling.request(2):
        assert work(1) == 2
    assert profiling.span("test.c") is first
    # a whole CLI note, spans off
    _render(src, tmp_path / "out.wav")
    monkeypatch.undo()
    after = _since(before)
    assert after.spans == {} and after.records == []
    # counters are always on
    assert after.counters["plan.notes"] == 1


def test_spans_nest_with_parent_request_and_notes(spans_on):
    before = profiling.snapshot()
    with profiling.request(notes=4):
        with profiling.span("test.outer", notes=4):
            with profiling.span("test.inner", notes=2):
                pass
            with profiling.request(notes=9):    # an entry point joins
                with profiling.span("test.inner", notes=2):
                    pass
    with profiling.span("test.alone"):
        pass
    recs = {}
    for r in _since(before).records:
        recs.setdefault(r.name, []).append(r)
    (req,), (outer,), inner = recs["request"], recs["test.outer"], \
        recs["test.inner"]
    assert req.parent == 0 and req.request == req.id and req.notes == 4
    assert outer.parent == req.id and outer.request == req.id
    assert [r.parent for r in inner] == [outer.id, outer.id]
    assert all(r.request == req.id and r.notes == 2 for r in inner)
    assert req.start_ns <= outer.start_ns <= inner[0].start_ns
    assert inner[-1].end_ns <= outer.end_ns <= req.end_ns
    # outside any request a span starts a request of its own
    (alone,) = recs["test.alone"]
    assert alone.request == alone.id != req.id and alone.parent == 0
    totals = _since(before).spans
    assert totals["test.inner"][0] == 2 and totals["test.inner"][2] == 4


def _by_request(records) -> dict:
    out: dict = {}
    for r in records:
        out.setdefault(r.request, []).append(r)
    return out


@pytest.mark.parametrize("path", ["cli", "phrase", "mesh"])
def test_one_request_id_per_request(src, tmp_path, spans_on, path):
    """Every span of a CLI note or of a phrase carries its request's id,
    the mesh's worker threads included (run_on_slots copies the
    caller's context)."""
    import threading

    from goofer_tpu_torch.parallel.mesh import make_mesh
    from goofer_tpu_torch.sampler import phrase

    before = profiling.snapshot()
    if path == "cli":
        for i in range(2):
            _render(src, tmp_path / f"out{i}.wav")
    else:
        mesh = (make_mesh(devices=[torch.device("cpu"),
                                   torch.device("cpu", 0)])
                if path == "mesh" else None)
        for i in range(2):
            # fresh notes each time: the plan memo would skip ``prepare``
            specs = [phrase.NoteSpec(str(src), ("C4", "D4")[i], length=300,
                                     consonant=60) for _ in range(4)]
            phrase.render_phrase_to_wavs(
                specs, [tmp_path / f"{i}_{j}.wav" for j in range(4)],
                pcm16=True, mesh=mesh)
    requests = _by_request(_since(before).records)
    assert len(requests) == 2
    for rid, recs in requests.items():
        (req,) = [r for r in recs if r.name == "request"]
        assert req.id == rid and req.notes == (1 if path == "cli" else 4)
        names = {r.name for r in recs}
        assert {"features.acquire", "plan.prepare", "plan.cut",
                "render.upload", "render.issue", "render.fetch",
                "io.write"} <= names
        assert all(req.start_ns <= r.start_ns <= r.end_ns <= req.end_ns
                   for r in recs)
        if path != "cli":
            assert {"plan.phrase", "plan.memo", "plan.bucket",
                    "phrase.groups", "phrase.group", "render.wait"} <= names
        threads = {r.thread for r in recs if r.name == "phrase.group"}
        if path == "mesh":
            assert threading.get_ident() not in threads


def test_features_memo_counters(tmp_path, monkeypatch):
    """66 sources through the decoded-features memo: 66 misses, each a
    load and a decode, and one clear (at the 66th, past 64 held); then a
    source still held hits."""
    from goofer_tpu_torch.sampler import resampler

    monkeypatch.setattr(resampler, "_decoded_cache", {})
    goofy = VOICE / "src_features.goofy"
    for i in range(66):
        (tmp_path / f"s{i}_features.goofy").symlink_to(goofy)
    before = profiling.snapshot()
    for i in range(66):
        resampler.acquire_features(tmp_path / f"s{i}.wav", 1024, 256, "cpu")
    resampler.acquire_features(tmp_path / "s65.wav", 1024, 256, "cpu")
    c = _since(before).counters
    assert c == {"features.memo.miss": 66, "features.memo.clear": 1,
                 "features.memo.hit": 1}


def test_plan_memo_counters(src, monkeypatch):
    """A phrase planned twice: misses, then as many hits; a memo past its
    limit clears once."""
    from goofer_tpu_torch.sampler import phrase

    monkeypatch.setattr(phrase, "_plan_memo", {})
    specs = [phrase.NoteSpec(str(src), "C4", length=300 + 50 * i,
                             consonant=60) for i in range(3)]
    before = profiling.snapshot()
    phrase.plan_phrase(specs, device="cpu")
    assert _since(before).counters == {"plan.notes": 3, "plan.memo.miss": 3,
                                       "features.memo.miss": 1}
    before = profiling.snapshot()
    phrase.plan_phrase(specs, device="cpu")
    assert _since(before).counters == {"plan.notes": 3, "plan.memo.hit": 3,
                                       "features.memo.hit": 1}
    monkeypatch.setattr(phrase, "PLAN_MEMO_LIMIT", 1)
    before = profiling.snapshot()
    phrase.plan_phrase([phrase.NoteSpec(str(src), "D4", length=300)],
                       device="cpu")
    assert _since(before).counters["plan.memo.clear"] == 1


@pytest.mark.parametrize("flags,rows", [("pd40", 1), ("t10", 0)])
def test_pd_scale_counters(src, tmp_path, spans_off, flags, rows):
    """A pd note's render takes its scale on the device: one row counted
    under ``render.pd_scale``, none reflected (a CLI note is not
    bucketed); a note without pd counts nothing."""
    before = profiling.snapshot()
    _render(src, tmp_path / "out.wav", flags)
    c = _since(before).counters
    assert c.get("render.pd_scale", 0) == rows
    assert "render.pd_scale.reflected" not in c


def test_kernel_load_once_per_kernel(monkeypatch, tmp_path, spans_off):
    """``setup.kernel_load`` is recorded at a kernel's first use, with
    spans off too, and never again; a build counts ``setup.kernel_build``
    each time the compiler runs."""
    import ctypes

    from goofer_tpu_torch.ops.cuda import _build

    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Lib())
    monkeypatch.setattr(_build.subprocess, "run", lambda cmd, **kw: (
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"lib"),
        _build.subprocess.CompletedProcess(cmd, 0, "", ""))[1])
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    kernels = [_build.Kernel(n, "f", [ctypes.c_int])
               for n in ("pulse_accumulate", "one_pole_cascade")]
    before = profiling.snapshot()
    for _ in range(3):
        for k in kernels:
            k.function()
    got = _since(before)
    assert got.spans["setup.kernel_load"][0] == 2
    assert got.counters == {"setup.kernel_build": 2}
    before = profiling.snapshot()
    _build.Kernel("pulse_accumulate", "f", [ctypes.c_int]).function()
    got = _since(before)
    assert got.spans["setup.kernel_load"][0] == 1 and got.counters == {}


@pytest.mark.parametrize("how", ["profiler", "trace_dir"])
def test_profiler_holds_span_ranges(src, tmp_path, monkeypatch, spans_off,
                                    how):
    """While a torch.profiler records the host, each span is a range of
    its name in the trace; GOOFER_TPU_TRACE_DIR turns the spans on."""
    names = {"features.acquire", "plan.prepare", "plan.tracks",
             "render.upload", "render.issue", "render.fetch", "io.write"}
    if how == "profiler":
        acts = [torch.profiler.ProfilerActivity.CPU]
        profiling.enable(True)
        try:
            with torch.profiler.profile(activities=acts) as prof:
                _render(src, tmp_path / "out.wav")
        finally:
            profiling.enable(False)
        seen = {e.name for e in prof.events()}
    else:
        monkeypatch.setenv("GOOFER_TPU_TRACE_DIR", str(tmp_path / "trace"))
        _render(src, tmp_path / "out.wav")
        (trace,) = (tmp_path / "trace").glob("*.pt.trace.json")
        seen = {e.get("name") for e in
                json.loads(trace.read_text())["traceEvents"]}
    assert names <= seen


@pytest.mark.parametrize("path", ["cli", "phrase"])
def test_wav_bytes_equal_with_spans_on_and_off(src, tmp_path, path):
    from goofer_tpu_torch.sampler import phrase

    def render(tag):
        if path == "cli":
            return [_render(src, tmp_path / f"{tag}.wav", HEAVY)]
        specs = [phrase.NoteSpec(str(src), "C4", flags=HEAVY,
                                 length=300 + 50 * i, consonant=60)
                 for i in range(3)]
        outs = [tmp_path / f"{tag}_{i}.wav" for i in range(3)]
        phrase.render_phrase_to_wavs(specs, outs, pcm16=True)
        return [p.read_bytes() for p in outs]

    was = profiling.enable(False)
    try:
        off = render("off")
        profiling.enable(True)
        on = render("on")
    finally:
        profiling.enable(was)
    assert on == off


def _rec(id, parent, name, start, end, request=1):
    return profiling.SpanRecord(id, parent, request, name, start, end, 1, 0)


@pytest.mark.parametrize("records,unnamed", [
    # a request that its leaves cover whole
    ([_rec(1, 0, "request", 0, 10), _rec(2, 1, "a", 0, 4),
      _rec(3, 1, "b", 4, 10)], 0),
    # gaps between, before and after the leaves
    ([_rec(1, 0, "request", 0, 20), _rec(2, 1, "a", 2, 5),
      _rec(3, 1, "b", 8, 15)], 10),
    # a parent's own time is unnamed; overlapping leaves count once; a leaf
    # past the request's end is clipped to it
    ([_rec(1, 0, "request", 0, 100), _rec(2, 1, "p", 0, 50),
      _rec(3, 2, "c", 10, 30), _rec(4, 2, "d", 20, 40),
      _rec(5, 1, "e", 90, 120)], 100 - 30 - 10),
    # two requests: each counts only its own leaves (another thread's
    # leaf of request 1 overlaps request 7)
    ([_rec(1, 0, "request", 0, 10), _rec(2, 1, "a", 0, 10),
      _rec(7, 0, "request", 0, 10, request=7),
      _rec(8, 7, "a", 0, 3, request=7)], 7),
    # a request without leaves is all unnamed
    ([_rec(1, 0, "request", 5, 9)], 4),
], ids=["covered", "gaps", "nested", "two_requests", "bare"])
def test_unnamed_arithmetic(records, unnamed):
    assert profiling.unnamed_ns(records) == unnamed


def test_profile_logs_span_totals(src, tmp_path, monkeypatch, caplog):
    """GOOFER_TPU_PROFILE=1: the stage report, then a second record of the
    span totals, the stages among them as ``stage.<name>``."""
    monkeypatch.setenv("GOOFER_TPU_PROFILE", "1")
    caplog.set_level(logging.INFO, logger="goofer_tpu_torch")
    _render(src, tmp_path / "out.wav")
    msgs = [r.getMessage() for r in caplog.records]
    (i,) = [k for k, m in enumerate(msgs) if m.startswith("[profile] total")]
    spans = msgs[i + 1]
    assert spans.startswith("[spans] ")
    names = {ln.split()[0] for ln in spans.splitlines()[1:]}
    assert {"stage.features", "stage.resample", "stage.write",
            "features.acquire", "plan.prepare", "render.issue",
            "render.fetch", "io.write", "plan.notes"} <= names


@pytest.mark.parametrize("level,logged", [(logging.INFO, True),
                                          (logging.WARNING, False)])
def test_launch_line_only_when_logged(src, tmp_path, monkeypatch, caplog,
                                      level, logged):
    calls = []
    real = cli.launch_counts
    monkeypatch.setattr(cli, "launch_counts",
                        lambda: calls.append(1) or real())
    caplog.set_level(level, logger="goofer_tpu_torch")
    _render(src, tmp_path / "out.wav")
    assert bool(calls) == logged
    assert ("Kernel launches: " in caplog.text) == logged
