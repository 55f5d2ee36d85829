"""The port's note render vs goofer_tpu's on identical plans, on the CPU.

goofer_tpu's ``GooferResampler.prepare()`` plans a note from
tests/fixtures_common.make_synth_features(); ``from_jax_plan`` carries
the plan across, and both ``render_note_core``s run on it.  Budgets are
the parity suite's (tests/test_resample_oracle.py): deterministic paths
(noise stems zeroed, P0) within 5e-3 x peak outside pulse windows whose
onset can legitimately land one sample off (float32 f0 rounding in the
two frameworks), and <= 0.1 dB smoothed LSD over the whole note;
stochastic paths (different RNGs by design) <= 1 dB, or goofer_tpu's own
seed-to-seed distance + 0.5 dB where that is higher."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from goofer_tpu.ops.jitter import subharm_vibrato as j_subharm_vibrato  # noqa: E402
from goofer_tpu.sampler.render_core import render_note as j_render_note  # noqa: E402
from goofer_tpu.sampler.resampler import GooferResampler as JaxResampler  # noqa: E402
from goofer_tpu.utils.metrics import lsd_db  # noqa: E402
from goofer_tpu_torch.ops.jitter import subharm_vibrato  # noqa: E402
from goofer_tpu_torch.sampler import render_core  # noqa: E402
from goofer_tpu_torch.sampler.resampler import GooferResampler  # noqa: E402
from tests.fixtures_common import (  # noqa: E402
    DET_CONFIGS,
    HOP,
    N_FFT,
    NOTE_ARGS,
    SR,
    make_synth_features,
)
from tests.test_resample_oracle import (  # noqa: E402
    _device_f0_mask,
    _flip_exclusion_mask,
    _layer_f0s,
)

SLICE_IDS = ("env-fx", "loops-concat", "subharm")
SLICE_CONFIGS = [c for c in DET_CONFIGS if c[0] in SLICE_IDS]
# every DET config the port supports (no su/sj/vf/st): host planning only
PLAN_CONFIGS = [c for c in DET_CONFIGS
                if c[0] in ("env-fx", "loops-vel", "loops-avg",
                            "loops-concat", "subharm")]


@pytest.fixture(scope="module")
def features():
    return make_synth_features()


def _args(pitch, velocity, flags, ps, length_ms):
    return (pitch, velocity, flags, NOTE_ARGS["offset"], length_ms,
            NOTE_ARGS["consonant"], NOTE_ARGS["cutoff"], NOTE_ARGS["volume"],
            NOTE_ARGS["modulation"], NOTE_ARGS["tempo"], ps)


def _features_for(features, reverse):
    env, f0i, vmask, forms, sr, ylen = features
    if reverse:
        env, f0i, vmask = env[:, ::-1], f0i[::-1], vmask[::-1]
        forms = {k: np.asarray(forms[k])[::-1] for k in forms}
    return env, f0i, vmask, forms, sr, ylen


def _jax_plan(features, args, uv0):
    r = JaxResampler("/tmp/nonexistent.wav", "/dev/null", *args,
                     autorender=False)
    feats = _features_for(features, r.params.reverse)
    rs, arrays, scalars = r.prepare(*feats)
    sc = dict(scalars)
    if uv0:
        sc["uv_strength"] = 0.0
        sc["breath_strength"] = 0.0
    return rs, arrays, sc


def _render_both(features, args, uv0, seed=0):
    rs, arrays, sc = _jax_plan(features, args, uv0)
    out_jax = np.asarray(j_render_note(rs, arrays, sc,
                                       jax.random.PRNGKey(seed)))
    rs_t, tensors, sc_t = render_core.from_jax_plan(rs, arrays, sc, "cpu")
    out_t = render_core.render_note_core(
        rs_t, *(tensors[k] for k in render_core.ARRAY_KEYS), sc_t, seed)
    return out_t.numpy(), out_jax, (rs, arrays, sc), (rs_t, tensors, sc_t)


@pytest.mark.parametrize(
    "cfg_id,pitch,velocity,flags,ps,length_ms,min_keep,outliers",
    SLICE_CONFIGS, ids=[c[0] for c in SLICE_CONFIGS])
def test_render_matches_jax_deterministic(features, cfg_id, pitch, velocity,
                                          flags, ps, length_ms, min_keep,
                                          outliers):
    out_t, out_j, jplan, tplan = _render_both(
        features, _args(pitch, velocity, flags, ps, length_ms), uv0=True)
    assert out_t.shape == out_j.shape and np.isfinite(out_t).all()
    n = len(out_j)

    f0_j, mask_j = _device_f0_mask(*jplan)
    rs_t, tensors, sc_t = tplan
    _, f0_t, mask_t = render_core.assemble_f0_mask(
        rs_t, tensors["f0_cut"], tensors["mask_cut"],
        tensors["pitch_ticks"], sc_t)
    f0_t, mask_t = f0_t.numpy(), mask_t.numpy()
    np.testing.assert_allclose(f0_t, f0_j, atol=1e-2)

    sg_on = rs_t.add_subharm
    vib_t = vib_j = None
    if sg_on:
        vib_t = subharm_vibrato(torch.as_tensor(f0_t), SR, 75.0, 3.0,
                                0.01).numpy()
        vib_j = np.asarray(j_subharm_vibrato(
            jnp.asarray(f0_j), SR, jnp.float32(75.0), jnp.float32(3.0),
            0.01))
    keep = _flip_exclusion_mask(
        _layer_f0s(f0_t, mask_t, False, sg_on, SR, vib_t),
        _layer_f0s(f0_j, mask_j, False, sg_on, SR, vib_j), f0_j, SR, n)
    assert keep.mean() > min_keep, keep.mean()

    peak = float(np.max(np.abs(out_j)) + 1e-12)
    d = np.abs(out_t[keep] - out_j[keep]) / peak
    if outliers == 0.0:
        assert d.max() <= 5e-3, d.max()
    else:
        assert float((d > 5e-3).mean()) <= outliers, (d.max(),)
    assert lsd_db(out_t, out_j, SR, N_FFT, HOP) < 0.1


@pytest.mark.parametrize("flags", ["", "sh30sr30"])
def test_render_matches_jax_stochastic(features, flags):
    """Noise stems on (and for sh30sr30 pitch and volume jitter), drawn
    from different RNGs: parity is spectral.  The budget is 1 dB, or
    goofer_tpu's own seed-to-seed distance + 0.5 dB where that floor is
    higher (the golden suite's protocol): sh30sr30 measures 1.33-1.49 dB
    between two goofer_tpu seeds on this note."""
    args = _args("C4", 100, flags, "AA", 420)
    out_t, out_j, (rs, arrays, sc), _ = _render_both(features, args,
                                                     uv0=False)
    assert out_t.shape == out_j.shape and np.isfinite(out_t).all()
    floor = lsd_db(np.asarray(j_render_note(rs, arrays, sc,
                                            jax.random.PRNGKey(1))),
                   out_j, SR, N_FFT, HOP)
    lsd = lsd_db(out_t, out_j, SR, N_FFT, HOP)
    assert lsd <= max(1.0, floor + 0.5), (lsd, floor)


@pytest.mark.parametrize(
    "cfg_id,pitch,velocity,flags,ps,length_ms",
    [c[:6] for c in PLAN_CONFIGS], ids=[c[0] for c in PLAN_CONFIGS])
def test_prepare_matches_jax(features, cfg_id, pitch, velocity, flags, ps,
                             length_ms):
    """The port's host planning builds goofer_tpu's arrays exactly."""
    args = _args(pitch, velocity, flags, ps, length_ms)
    rs_j, arrays_j, sc_j = _jax_plan(features, args, uv0=False)
    r = GooferResampler("/tmp/nonexistent.wav", "/dev/null", *args,
                        device="cpu", autorender=False)
    rs_t, arrays_t, sc_t = r.prepare(
        *_features_for(features, r.params.reverse))
    assert rs_t == render_core.from_jax_plan(rs_j, arrays_j, sc_j, "cpu")[0]
    assert arrays_t.keys() == arrays_j.keys()
    for k in arrays_t:
        assert arrays_t[k].dtype == np.asarray(arrays_j[k]).dtype, k
        np.testing.assert_array_equal(arrays_t[k], arrays_j[k], err_msg=k)
    for k, v in sc_t.items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(sc_j[k]),
                                      err_msg=k)


def test_render_entry_matches_core(features):
    """render_note (host arrays -> device tensors) is render_note_core on
    from_jax_plan's inputs."""
    args = _args("C4", 100, "br30P0", "AA", 300)
    rs, arrays, sc = _jax_plan(features, args, uv0=True)
    rs_t, tensors, sc_t = render_core.from_jax_plan(rs, arrays, sc, "cpu")
    a = render_core.render_note(rs_t, arrays, sc, 3, "cpu")
    b = render_core.render_note_core(
        rs_t, *(tensors[k] for k in render_core.ARRAY_KEYS), sc_t, 3)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
