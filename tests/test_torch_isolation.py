"""goofer_tpu_torch stands alone: no JAX, no silent CPU fallback, and
every flag of the 13-argument CLI plans."""
import pytest

torch = pytest.importorskip("torch")

import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from goofer_tpu_torch import config  # noqa: E402
from goofer_tpu_torch.ops.cuda import (  # noqa: E402
    _build,
    blur_kernel,
    cascade_kernel,
    pulse_kernel,
)
from goofer_tpu_torch.sampler.resampler import GooferResampler  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import goofer_tpu_torch.cli, goofer_tpu_torch.sampler.resampler\n"
        "import goofer_tpu_torch.ops.pulse, goofer_tpu_torch.engine.synth\n"
        "import goofer_tpu_torch.ops.scan_iir, goofer_tpu_torch.ops.noise\n"
        "import goofer_tpu_torch.sampler.phrase\n"
        "import goofer_tpu_torch.analysis.pitch\n"
        "import goofer_tpu_torch.analysis.formants\n"
        "import goofer_tpu_torch.analysis.features\n"
        "import goofer_tpu_torch.sampler.batch_extract\n"
        "import goofer_tpu_torch.io.goofy, goofer_tpu_torch.utils.audio_io\n"
        "import goofer_tpu_torch.ops.cuda.viterbi_kernel\n"
        "import goofer_tpu_torch.ops.cuda.lpc_roots_kernel\n"
        "import goofer_tpu_torch.ops.cuda.burg_kernel\n"
        "import goofer_tpu_torch.sampler.server\n"
        "import goofer_tpu_torch.sampler.manifest\n"
        "import goofer_tpu_torch.models.hnm, goofer_tpu_torch.compat\n"
        "import goofer_tpu_torch.native\n"
        "import goofer_tpu_torch.editor.core, goofer_tpu_torch.editor.gui\n"
        "import goofer_tpu_torch.parallel, goofer_tpu_torch.parallel.mesh\n"
        "import goofer_tpu_torch.parallel.batch\n"
        "import goofer_tpu_torch.parallel.dryrun\n"
        "import goofer_tpu_torch.devices\n"
        "import goofer_tpu_torch.analysis, goofer_tpu_torch.engine\n"
        "import goofer_tpu_torch.io, goofer_tpu_torch.models\n"
        "import goofer_tpu_torch.ops, goofer_tpu_torch.sampler\n"
        "import goofer_tpu_torch.utils\n"
        "import goofer_tpu_torch.utils.profiling\n"
        "import goofer_tpu_torch.ops.cuda.blur_kernel\n"
        "import runpy\n"
        "runpy.run_path('examples/engine_selftest_torch.py', "
        "run_name='example')\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'goofer_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def _pulse_args(device="cpu"):
    """A (1, 64) main-pass f0 row and the pass's scalars."""
    f0 = torch.full((1, 64), 220.0, device=device)
    return f0, None, 44100.0, 1.0, 160.0, 0.02, 1.7, 0.8, True, 8, 16


def _no_nvcc(monkeypatch, tmp_path, module):
    """No build exists and nvcc is missing; the device check accepts the
    meta tensors that stand in for CUDA ones."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(module.KERNEL, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(module, "_check_inputs", lambda *args: None)


def test_pulse_wrapper_never_falls_back(monkeypatch, tmp_path):
    """A CUDA tensor with no buildable kernel raises: it does not take the
    plain version."""
    _no_nvcc(monkeypatch, tmp_path, pulse_kernel)
    before = pulse_kernel.pulse_accumulate.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        pulse_kernel.pulse_accumulate(*_pulse_args("meta"))
    assert pulse_kernel.pulse_accumulate.launches == before


def test_cascade_wrapper_never_falls_back(monkeypatch, tmp_path):
    _no_nvcc(monkeypatch, tmp_path, cascade_kernel)
    before = cascade_kernel.one_pole_cascade.launches
    x = torch.zeros((1, 64), device="meta")
    with pytest.raises(RuntimeError, match="nvcc"):
        cascade_kernel.one_pole_cascade(x, torch.ones(64, device="meta"), 6,
                                        "highpass")
    assert cascade_kernel.one_pole_cascade.launches == before


def test_blur_wrapper_never_falls_back(monkeypatch, tmp_path):
    _no_nvcc(monkeypatch, tmp_path, blur_kernel)
    before = blur_kernel.gaussian_blur.launches
    x = torch.zeros((2, 64), device="meta")
    with pytest.raises(RuntimeError, match="nvcc"):
        blur_kernel.gaussian_blur(x, np.full(5, 0.2, np.float32))
    assert blur_kernel.gaussian_blur.launches == before


def test_blur_wrapper_rejects_other_devices():
    x = torch.zeros((2, 64), device="meta")
    with pytest.raises(ValueError, match="expected"):
        blur_kernel.gaussian_blur(x, np.full(5, 0.2, np.float32))


def test_blur_wrapper_cpu_runs_plain():
    """A CPU tensor takes the plain version and counts no launch."""
    from goofer_tpu_torch.ops.filters import blur_plain, gaussian_kernel1d

    before = blur_kernel.gaussian_blur.launches
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (3, 40, 7)).astype(np.float32))
    taps = gaussian_kernel1d(2.0)
    for axis in (-1, -2):
        assert torch.equal(blur_kernel.gaussian_blur(x, taps, axis),
                           blur_plain(x, taps, axis))
    assert blur_kernel.gaussian_blur.launches == before


def test_cascade_wrapper_rejects_other_devices():
    x = torch.zeros((1, 64), device="meta")
    with pytest.raises(ValueError, match="expected"):
        cascade_kernel.one_pole_cascade(x, torch.ones(64, device="meta"), 6,
                                        "highpass")


def test_pulse_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="expected"):
        pulse_kernel.pulse_accumulate(*_pulse_args("meta"))


def test_pulse_wrapper_cpu_runs_plain():
    from goofer_tpu_torch.ops.pulse import pulse_pass_plain

    before = pulse_kernel.pulse_accumulate.launches
    args = _pulse_args()
    out = pulse_kernel.pulse_accumulate(*args)
    assert out.shape == (1, 64) and out.dtype == torch.float32
    assert torch.equal(out, pulse_pass_plain(*args))
    assert pulse_kernel.pulse_accumulate.launches == before


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        config.get_device("cuda")
    monkeypatch.delenv(config.DEVICE_ENV, raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        config.get_device()
    assert config.get_device("cpu").type == "cpu"


@pytest.mark.parametrize("flags,toggle,value", [
    ("su40", "su_on", True), ("vf30", "fry_on", True),
    ("sj20", "sj_on", True), ("st-25", "tension_sign", -1)])
def test_unported_flags_raise(flags, toggle, value):
    """The flags that once refused (su, vf, sj, st) now plan, and set
    their RenderStatic toggle; no other layer switches on."""
    r = GooferResampler("/tmp/nonexistent.wav", "/dev/null", "C4", 100,
                        flags, device="cpu", autorender=False)
    n = 44100
    env = np.ones((513, 1 + n // 256), dtype=np.float32)
    f0 = np.full(n, 220.0, dtype=np.float32)
    rs, _, scalars = r.prepare(env, f0, np.ones(n, np.float32), {}, 44100, n)
    assert getattr(rs, toggle) == value
    layers = {"su_on": rs.su_on, "fry_on": rs.fry_on, "sj_on": rs.sj_on,
              "tension_sign": rs.tension_sign != 0}
    assert [k for k, on in layers.items() if on] == [toggle]
    if toggle == "tension_sign":
        assert rs.tension_order == 2 and scalars["tension"] == -0.25
