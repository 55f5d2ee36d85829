"""goofer_tpu_torch stands alone: no JAX, no silent CPU fallback, and the
flags it has not ported refuse loudly."""
import pytest

torch = pytest.importorskip("torch")

import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from goofer_tpu_torch import config  # noqa: E402
from goofer_tpu_torch.ops.cuda import pulse_kernel  # noqa: E402
from goofer_tpu_torch.sampler.resampler import GooferResampler  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import goofer_tpu_torch.cli, goofer_tpu_torch.sampler.resampler\n"
        "import goofer_tpu_torch.ops.pulse, goofer_tpu_torch.engine.synth\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'goofer_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def _tables(device="cpu"):
    row = torch.zeros((1, 64), dtype=torch.int32, device=device)
    tab = torch.ones((1, 6), dtype=torch.float32, device=device)
    return row, tab, tab, tab, tab


def test_pulse_wrapper_never_falls_back(monkeypatch, tmp_path):
    """A CUDA tensor with no buildable kernel raises: it does not take the
    plain version.  The CUDA tensor is faked by accepting meta tensors in
    the device check; the build fails for want of nvcc."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(pulse_kernel, "_lib", None)
    monkeypatch.setattr(pulse_kernel, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(pulse_kernel, "find_nvcc", no_nvcc)
    monkeypatch.setattr(pulse_kernel, "_check_inputs", lambda row, tabs: None)
    before = pulse_kernel.pulse_accumulate.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        pulse_kernel.pulse_accumulate(*_tables("meta"), 0.02, 1.7, 0.8,
                                      True, 8)
    assert pulse_kernel.pulse_accumulate.launches == before


def test_pulse_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="expected"):
        pulse_kernel.pulse_accumulate(*_tables("meta"), 0.02, 1.7, 0.8,
                                      True, 8)


def test_pulse_wrapper_cpu_runs_plain():
    row, *tabs = _tables()
    out = pulse_kernel.pulse_accumulate(row, *tabs, 0.02, 1.7, 0.8, True, 8)
    assert out.shape == (1, 64) and out.dtype == torch.float32


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        config.get_device("cuda")
    monkeypatch.delenv(config.DEVICE_ENV, raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        config.get_device()
    assert config.get_device("cpu").type == "cpu"


@pytest.mark.parametrize("flags,name", [("su40", "su"), ("vf30", "vf"),
                                        ("sj20", "sj"), ("st-25", "st")])
def test_unported_flags_raise(flags, name):
    r = GooferResampler("/tmp/nonexistent.wav", "/dev/null", "C4", 100,
                        flags, device="cpu", autorender=False)
    n = 44100
    env = np.ones((513, 1 + n // 256), dtype=np.float32)
    f0 = np.full(n, 220.0, dtype=np.float32)
    with pytest.raises(NotImplementedError, match=rf"\b{name}\b"):
        r.prepare(env, f0, np.ones(n, np.float32), {}, 44100, n)
