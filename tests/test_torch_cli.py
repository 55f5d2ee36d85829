"""The port's 13-argument CLI render on the CPU (its plain versions),
from the vendored golden .goofy caches; tests/test_torch_extract.py holds
the folder mode and the render of a source without a cache."""
import pytest

torch = pytest.importorskip("torch")

import shutil  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from goofer_tpu_torch import cli  # noqa: E402
from goofer_tpu_torch.utils.audio_io import read_wav  # noqa: E402
from goofer_tpu_torch.utils.metrics import lsd_db  # noqa: E402

GOLDEN = Path(__file__).parent / "golden" / "ref"
# tests/test_golden.py's budget for these configs: the upstream
# seed-to-seed LSD floor + 0.5 dB
BUDGET_DB = {"neutral": 0.76 + 0.5, "formant_chain": 1.04 + 0.5}
ARGS = {
    "neutral": ["C4", "100", "", "0", "500", "60", "0", "100", "0", "!120",
                "AA"],
    "formant_chain": ["C4", "100", "g-15fa8fb-6fw25br30es20", "0", "500",
                      "60", "0", "100", "0", "!120", "AA"],
}


@pytest.fixture
def src(tmp_path, monkeypatch):
    monkeypatch.setenv("GOOFER_TPU_TORCH_DEVICE", "cpu")
    shutil.copy(GOLDEN / "src.wav", tmp_path / "src.wav")
    shutil.copy(GOLDEN / "src_features.goofy",
                tmp_path / "src_features.goofy")
    return tmp_path / "src.wav"


@pytest.mark.parametrize("name", sorted(BUDGET_DB))
def test_cli_render_within_golden_budget(src, name):
    out = src.with_name(f"out_{name}.wav")
    assert cli.main([str(src), str(out)] + ARGS[name]) == 0
    ours, sr = read_wav(out)
    golden, sr_g = read_wav(GOLDEN / f"out_{name}.wav")
    assert sr == sr_g and len(ours) == len(golden)
    assert np.isfinite(ours).all()
    lsd = lsd_db(np.float32(ours), np.float32(golden), sr)
    assert lsd <= BUDGET_DB[name], lsd


def test_cli_render_reversed_with_velocity(src):
    out = src.with_name("out_rev.wav")
    argv = [str(src), str(out), "D4", "140", "R1L1sd30sa20", "0", "700",
            "60", "0", "100", "0", "!120", "ABAC#3#AD"]
    assert cli.main(argv) == 0
    y, sr = read_wav(out)
    assert sr == 44100 and np.isfinite(y).all() and np.abs(y).max() > 0.1


def test_cli_unported_modes_and_errors(src, tmp_path, monkeypatch):
    from goofer_tpu_torch.sampler import server

    served = []
    monkeypatch.setattr(server, "run", lambda: served.append(1))
    assert cli.main([]) == 0 and served == [1]                # server

    def bad_args():
        raise TypeError("bad")

    monkeypatch.setattr(server, "run", bad_args)
    assert cli.main([]) == 0                                  # help
    # the editor mode is ported: a missing .goofy is skipped, as in
    # goofer_tpu (tests/test_torch_editor.py holds the mode itself)
    assert cli.main([str(tmp_path / "a.goofy")]) == 0
    assert cli.main([str(src), "out.wav", "C4"]) == 1         # too few
    assert cli.main([str(tmp_path / "nowhere")]) == 1         # no such path
    # the folder mode is ported: src.wav has its cache, nothing to do
    assert cli.main([str(tmp_path)]) == 0
    assert sorted(p.name for p in tmp_path.glob("*.goofy")) == [
        "src_features.goofy"]
    # a source without a .goofy is analysed, and its cache saved
    fresh = tmp_path / "other.wav"
    shutil.copy(src, fresh)
    argv = [str(fresh), str(tmp_path / "o.wav")] + ARGS["neutral"]
    assert cli.main(argv) == 0
    assert (tmp_path / "o.wav").exists()
    assert (tmp_path / "other_features.goofy").exists()
    # a source that cannot be read still fails, and writes nothing
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFFnope")
    argv = [str(bad), str(tmp_path / "b.wav")] + ARGS["neutral"]
    assert cli.main(argv) == 1
    assert not (tmp_path / "b.wav").exists()
    assert not (tmp_path / "bad_features.goofy").exists()
