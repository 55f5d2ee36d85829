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
