"""The Hopper pulse kernel against its plain version, on the card.

Marked ``cuda``: these skip without a CUDA device.  Run them on the
machine with the card (``--noconftest``: tests/conftest.py imports JAX,
which that machine does not have):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance 1e-4: both sides are float32 and the sum holds at most K terms
of size <= 1, so it leaves room only for CUDA vs ATen transcendental
rounding."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from goofer_tpu_torch.ops import pulse  # noqa: E402
from goofer_tpu_torch.ops.cuda.pulse_kernel import pulse_accumulate  # noqa: E402
from goofer_tpu_torch.sampler import render_core  # noqa: E402
from goofer_tpu_torch.sampler.resampler import GooferResampler  # noqa: E402
from goofer_tpu_torch.utils.metrics import lsd_db  # noqa: E402
from tests.fixtures_common import (  # noqa: E402
    DET_CONFIGS,
    NOTE_ARGS,
    make_synth_features,
)

pytestmark = pytest.mark.cuda
SR = 44100


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _f0(n, batch):
    t = np.arange(n) / SR
    rng = np.random.default_rng(0)
    base = rng.uniform(90.0, 600.0, (batch, 1))
    f0 = base * 2 ** (0.3 * np.sin(2 * np.pi * 3.0 * t))[None]
    f0[:, : n // 8] = 0.0
    return f0.astype(np.float32)


@pytest.mark.parametrize("guard,rk,k", [(True, 0.8, 16), (False, 1.0, 8)])
@pytest.mark.parametrize("batch,n", [(1, 40000), (4, 9000)])
def test_kernel_matches_plain(dev, guard, rk, k, batch, n):
    f0 = torch.as_tensor(_f0(n, batch), device=dev)
    onset = pulse._onsets_from_phase(torch.cumsum(f0.double() / SR, dim=-1))
    tables = pulse._compact_onset_tables(onset, f0, f0 > 1e-6, 160.0, SR,
                                         0.02, 1.7, rk, guard, 16)
    before = pulse_accumulate.launches
    got = pulse_accumulate(*tables, 0.02, 1.7, rk, guard, k)
    want = pulse.accumulate_pulses_plain(*tables, 0.02, 1.7, rk, guard, k)
    torch.cuda.synchronize()
    assert pulse_accumulate.launches == before + 1
    assert got.shape == (batch, n) and float(got.abs().max()) > 0.5
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0.0)


def test_pulse_train_on_card_matches_cpu(dev):
    f0 = _f0(20000, 1)[0]
    got = pulse.pulse_train(torch.as_tensor(f0, device=dev), SR).cpu()
    want = pulse.pulse_train(torch.as_tensor(f0), SR)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0.0)


def test_wrapper_rejects_bad_inputs(dev):
    row = torch.zeros((1, 64), dtype=torch.int64, device=dev)
    tab = torch.ones((1, 6), device=dev)
    with pytest.raises(ValueError, match="int32"):
        pulse_accumulate(row, tab, tab, tab, tab, 0.02, 1.7, 0.8, True, 8)
    row = row.int()
    with pytest.raises(ValueError, match="tables"):
        pulse_accumulate(row, tab.double(), tab, tab, tab, 0.02, 1.7, 0.8,
                         True, 8)


@pytest.mark.parametrize("cfg_id", ["env-fx", "loops-concat", "subharm"])
def test_render_on_card_matches_cpu(dev, cfg_id):
    """The whole deterministic note chain (noise stems zeroed, P0) on the
    card against the same port on the CPU: cuFFT, cuDNN and CUDA math
    against pocketfft, oneDNN and the CPU kernels.  The parity suite's
    budgets: <= 0.1 dB LSD, and 5e-3 x peak on all but 0.1% of samples
    (a pulse onset whose phase sits within rounding of an integer may
    land one sample off)."""
    _, pitch, vel, flags, ps, length_ms, _, _ = next(
        c for c in DET_CONFIGS if c[0] == cfg_id)
    r = GooferResampler(
        "/nonexistent.wav", "/dev/null", pitch, vel, flags,
        NOTE_ARGS["offset"], length_ms, NOTE_ARGS["consonant"],
        NOTE_ARGS["cutoff"], NOTE_ARGS["volume"], NOTE_ARGS["modulation"],
        NOTE_ARGS["tempo"], ps, device="cpu", autorender=False)
    rs, arrays, sc = r.prepare(*make_synth_features())
    sc = dict(sc, uv_strength=0.0, breath_strength=0.0)
    before = pulse_accumulate.launches
    gpu = render_core.render_note(rs, arrays, sc, 0, dev).cpu().numpy()
    assert pulse_accumulate.launches > before
    cpu = render_core.render_note(rs, arrays, sc, 0, "cpu").numpy()
    assert gpu.shape == cpu.shape and np.isfinite(gpu).all()
    d = np.abs(gpu - cpu) / (np.abs(cpu).max() + 1e-12)
    assert float((d > 5e-3).mean()) <= 1e-3, float(d.max())
    assert lsd_db(gpu, cpu, SR) < 0.1
