"""The port's pulse train vs goofer_tpu's on the CPU.

On the CPU the kernel wrapper runs the plain PyTorch accumulation
(ops/pulse.py:accumulate_pulses_plain); the Hopper kernel itself is
checked against that plain version on the card (tests/test_torch_cuda.py
and chip_smoke.py).  Tolerances: on the same onset mask the accumulations
are float32 sums of at most K terms of size <= 1 (atol 1e-5); the full
trains also decide their own onsets (float64 phase here, TwoSum float32
phase in goofer_tpu), so pitches stay off exact integer-period ties and
the budget is 5e-3."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from goofer_tpu import config as j_config  # noqa: E402
from goofer_tpu.ops import pulse as j_pulse  # noqa: E402
from goofer_tpu_torch.ops import pulse  # noqa: E402
from goofer_tpu_torch.ops.cuda.pulse_kernel import pulse_accumulate  # noqa: E402

SR = 44100
MAIN = (0.02, 1.7, 0.8, True)       # pulse_train's LF shape
SUB = (0.02, 1.7, 1.0, False)       # subharm_pulse_train's


def _glide(n, gap=True):
    t = np.arange(n) / SR
    f0 = (200.0 * 2 ** (0.4 * np.sin(2 * np.pi * 2.0 * t))).astype(
        np.float32)
    if gap:
        f0[int(0.3 * n): int(0.45 * n)] = 0.0
    return f0


def _onset(f0):
    phase = np.cumsum(f0.astype(np.float64) / SR)
    k = np.floor(phase)
    return k > np.concatenate([[0.0], k[:-1]])


def _tables(onset, f0, valid, fallback, shape, spacing):
    return pulse._compact_onset_tables(
        torch.as_tensor(onset)[None], torch.as_tensor(f0)[None],
        torch.as_tensor(valid)[None], fallback, SR, *shape, spacing)


@pytest.mark.parametrize("shape", [MAIN, SUB], ids=["guard", "noguard"])
def test_compact_tables_match_jax(shape):
    n = 6000
    f0 = _glide(n)
    onset, valid = _onset(f0), f0 > 1e-6
    got = _tables(onset, f0, valid, 160.0, shape, 16)
    want = j_pulse._compact_onset_tables(
        n, jnp.asarray(onset), jnp.asarray(f0), jnp.asarray(valid), 160.0,
        SR, *shape, 16)
    # row, position, period: exact; the grid peak goes through sin/exp/cos,
    # whose float32 implementations differ by an ulp
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    np.testing.assert_allclose(got[4][0].numpy(), np.asarray(want[4]),
                               rtol=1e-6)


@pytest.mark.parametrize("k", [8, 16])
@pytest.mark.parametrize("shape", [MAIN, SUB], ids=["guard", "noguard"])
def test_plain_accumulation_matches_blocked(shape, k):
    """Same onset mask into both: the K-bounded sum equals goofer_tpu's
    production blocked accumulation."""
    n = 8192
    f0 = _glide(n)
    onset, valid = _onset(f0), f0 > 1e-6
    got = pulse_accumulate(*_tables(onset, f0, valid, 160.0, shape, 16),
                           *shape, k)[0]
    want = j_pulse._accumulate_pulses_blocked(
        n, jnp.asarray(onset), jnp.asarray(f0), jnp.asarray(valid), 160.0,
        SR, *shape, k, 16)
    assert float(got.abs().max()) > 0.5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_plain_accumulation_batch_rows_independent():
    n = 4096
    f0s = [_glide(n), np.full(n, 311.7, np.float32), np.zeros(n, np.float32)]
    onsets = np.stack([_onset(f) for f in f0s])
    f0b = np.stack(f0s)
    tabs = pulse._compact_onset_tables(
        torch.as_tensor(onsets), torch.as_tensor(f0b),
        torch.as_tensor(f0b > 1e-6), 160.0, SR, *MAIN, 16)
    batch = pulse_accumulate(*tabs, *MAIN, 8)
    for b, f in enumerate(f0s):
        one = pulse_accumulate(*_tables(onsets[b], f, f > 1e-6, 160.0, MAIN,
                                        16), *MAIN, 8)[0]
        np.testing.assert_array_equal(batch[b].numpy(), one.numpy())
    assert float(batch[2].abs().max()) == 0.0


@pytest.mark.parametrize("case", ["const220.3", "const97.1", "glide"])
def test_pulse_train_matches_jax(case):
    n = 12000
    if case == "glide":
        f0 = _glide(n)
    else:
        f0 = np.full(n, float(case[5:]), dtype=np.float32)
        f0[: n // 8] = 0.0
    got = pulse.pulse_train(torch.as_tensor(f0), SR, max_overlap=16,
                            min_spacing=16)
    want = j_pulse.pulse_train(jnp.asarray(f0), SR, max_overlap=16,
                               min_spacing=16)
    assert got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3)


def test_pulse_train_silence():
    got = pulse.pulse_train(torch.zeros(3000), SR)
    assert float(got.abs().max()) == 0.0


def test_subharm_pulse_train_matches_jax():
    n = 12000
    f0 = _glide(n, gap=False) * np.float32(1.013)
    mask = np.ones(n, dtype=np.float32)
    mask[4000:5500] = 0.0
    got = pulse.subharm_pulse_train(torch.as_tensor(f0), SR,
                                    torch.as_tensor(mask), [12.0], 0.9)
    want = j_pulse.subharm_pulse_train(jnp.asarray(f0), SR,
                                       jnp.asarray(mask), [12.0], 0.9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3)


@pytest.mark.slow
@pytest.mark.parametrize("f0_hz", [220.3, 97.1])
def test_plain_accumulation_matches_pallas_interpret(f0_hz):
    """Against the Pallas TPU kernel itself, in interpret mode (~40 s)."""
    n = 4096
    f0 = np.full(n, f0_hz, dtype=np.float32)
    f0[: n // 8] = 0.0
    onset, valid = _onset(f0), f0 > 1e-6
    got = pulse_accumulate(*_tables(onset, f0, valid,
                                    j_config.PULSE_FALLBACK_F0, MAIN, 16),
                           *MAIN, 16)[0]
    want = j_pulse._accumulate_pulses_pallas(
        n, jnp.asarray(onset), jnp.asarray(f0), jnp.asarray(valid),
        j_config.PULSE_FALLBACK_F0, SR, *MAIN, 16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
