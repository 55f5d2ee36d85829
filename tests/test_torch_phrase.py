"""The port's phrase renderer vs goofer_tpu's, on the CPU.

Small phrases (3-5 notes of 300-500 ms) sung from the vendored voice
source, copied with its ``.goofy`` so that both packages plan from the
same cached features.

* Planning: ``plan_phrase`` + ``group_planned`` of both packages on the
  same ``NoteSpec``s give the same groups, the same harmonized statics
  and the same arrays (the envelope through each package's own knot
  decode: rtol 1e-5, see tests/test_torch_ops.py; everything else
  exactly).
* The batched core against goofer_tpu's ``render_note_core`` under
  ``jax.vmap`` on JAX-planned groups carried across by ``from_jax_plan``.
  Noise strengths zeroed: 5e-3 x peak outside pulse windows whose onset
  can land one sample off (tests/test_resample_oracle.py) and <= 0.1 dB
  smoothed LSD.  Noise on (different RNGs by design): <= max(1 dB,
  goofer_tpu's seed-to-seed LSD + 0.5 dB).
* Bucketed groups: the port normalizes each row's inverse STFT by the
  window sum of its TRUE frames; goofer_tpu divides by the padded
  frames' sum, which attenuates the last n_fft samples before the true
  end and, through the peak normalization, can rescale the whole note.
  So the port's bucketed render is held to goofer_tpu's bucketed one
  with the peak normalization off (P0) and outside those n_fft samples,
  and everywhere to its own exact render, which is held to goofer_tpu's
  exact one.
* A phrase's row equals the note rendered alone with the same
  (seed, index) key, and the bucketed render equals the exact one over
  each note's true extent: the same ops on the same draws, 5e-3 x peak
  and 0.1 dB; with the pitch and volume jitters on (their smoothed noise
  is normalized over the padded length) <= 1 dB.
"""
import shutil
from functools import lru_cache, partial
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from goofer_tpu.sampler import phrase as j_phrase  # noqa: E402
from goofer_tpu.sampler.render_core import (  # noqa: E402
    default_scalars as j_default_scalars,
    render_note_core as j_render_note_core,
)
from goofer_tpu.utils.metrics import lsd_db  # noqa: E402
from goofer_tpu_torch.ops import pulse, scan_iir  # noqa: E402
from goofer_tpu_torch.sampler import phrase, render_core  # noqa: E402
from goofer_tpu_torch.sampler.phrase import NoteSpec  # noqa: E402
from goofer_tpu.ops.jitter import subharm_vibrato as j_subharm_vibrato  # noqa: E402
from goofer_tpu_torch.ops.jitter import subharm_vibrato  # noqa: E402
from tests.test_resample_oracle import (  # noqa: E402
    _device_f0_mask,
    _flip_exclusion_mask,
    _layer_f0s,
)

SR = 44100
N_FFT = 1024
HOP = 256
VOICE = Path(__file__).parent / "golden" / "voice"
HEAVY = "sh30sr30sg40su40sj20st-30vf40es30pd40fw20fsta50"


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_phrase_vb")
    shutil.copy(VOICE / "src.wav", d / "a.wav")
    shutil.copy(VOICE / "src_features.goofy", d / "a_features.goofy")
    return str(d / "a.wav")


def _specs(cls, src, rows):
    return [cls(src, pitch, length=length, consonant=60, flags=flags)
            for pitch, length, flags in rows]


PLAN_CASES = {
    # three notes share a signature; the fourth differs by length
    "equal-shapes": [("C4", 300, ""), ("E4", 300, ""), ("G4", 300, ""),
                     ("C5", 500, "")],
    # other scalar values, one signature
    "mixed-flags": [("C4", 300, "t50"), ("D4", 300, "t-50")],
    # pulse spacings differ over octaves and harmonize to the min
    "octave-span": [("A3", 300, ""), ("C4", 300, ""), ("A4", 300, ""),
                    ("C5", 300, "")],
    # with fry the overlap bounds differ and harmonize to the max
    "octave-span-fry": [(p, 300, HEAVY) for p in ("G3", "A3", "C5", "B4")],
    # five lengths: auto bucketing pads them into shared geometries
    "auto-bucket": [("C4", 300 + 37 * i, "t10") for i in range(5)],
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_and_groups_match_jax(src, case):
    rows = PLAN_CASES[case]
    planned_j, _ = j_phrase.plan_phrase(_specs(j_phrase.NoteSpec, src, rows))
    planned_t, _ = phrase.plan_phrase(_specs(NoteSpec, src, rows),
                                      device="cpu")
    assert len(planned_t) == len(planned_j) == len(rows)
    for pt, pj in zip(planned_t, planned_j):
        assert pt.index == pj.index
        assert pt.rs == render_core.static_from_jax(pj.rs)
        for k in phrase.ARRAY_ORDER:
            a, b = np.asarray(pt.arrays[k]), np.asarray(pj.arrays[k])
            assert a.shape == b.shape and a.dtype == b.dtype, k
            if k == "env_cut":
                np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=k)
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)
        for k, v in pt.scalars.items():
            np.testing.assert_array_equal(np.asarray(v),
                                          np.asarray(pj.scalars[k]), k)
    groups_t = phrase.group_planned(planned_t)
    groups_j = j_phrase.group_planned(planned_j)
    assert ([[m.index for m in ms] for ms in groups_t.values()]
            == [[m.index for m in ms] for ms in groups_j.values()])
    assert ([rs for rs, _ in groups_t]
            == [render_core.static_from_jax(rs) for rs, _ in groups_j])
    assert [sk for _, sk in groups_t] == [sk for _, sk in groups_j]
    if case == "equal-shapes":
        assert [len(ms) for ms in groups_t.values()] == [3, 1]
    elif case == "octave-span":
        (rs, _), = groups_t
        assert len({pl.rs.min_spacing for pl in planned_t}) > 1
        assert rs.min_spacing == min(pl.rs.min_spacing for pl in planned_t)
    elif case == "octave-span-fry":
        (rs, _), = groups_t
        assert len({pl.rs.max_overlap for pl in planned_t}) > 1
        assert rs.max_overlap == max(pl.rs.max_overlap for pl in planned_t)
        assert rs.growl_max_overlap == max(pl.rs.growl_max_overlap
                                           for pl in planned_t)
    elif case == "auto-bucket":
        assert all(pl.rs.masked for pl in planned_t)
        assert len(groups_t) < len(rows)
    else:
        assert len(groups_t) == 1


def test_plan_memo_reuses_across_calls(src):
    """Replanning identical notes returns the SAME array objects and
    identical plans; a different flag misses."""
    notes = _specs(NoteSpec, src, [("C4", 300, "t10")])
    p1, _ = phrase.plan_phrase(notes, device="cpu")
    p2, _ = phrase.plan_phrase(notes, device="cpu")
    assert p1[0].rs == p2[0].rs
    for k in phrase.ARRAY_ORDER:
        assert p1[0].arrays[k] is p2[0].arrays[k]
    p3, _ = phrase.plan_phrase(_specs(NoteSpec, src, [("C4", 300, "t20")]),
                               device="cpu")
    assert not np.array_equal(p3[0].arrays["pitch_ticks"],
                              p1[0].arrays["pitch_ticks"])


def test_group_shares_arrays_by_object(src):
    """Notes of one source and cut share cut slices and tracks as the same
    objects; device_inputs then holds one copy, expanded over the batch."""
    planned, _ = phrase.plan_phrase(
        _specs(NoteSpec, src, [("C4", 300, "t7"), ("E4", 300, "t7")]),
        device="cpu")
    (rs, _), members = next(iter(phrase.group_planned(planned).items()))
    tensors, _, _ = render_core.device_inputs(
        rs, [m.arrays for m in members], [m.scalars for m in members],
        [0, 1], "cpu")
    for k in ("env_cut", "f0_cut", "mask_cut", "tracks", "tracks_raw"):
        assert members[0].arrays[k] is members[1].arrays[k], k
        assert tensors[k].shape[0] == 2 and tensors[k].stride(0) == 0, k
    assert tensors["pitch_ticks"].stride(0) != 0
    # plans of another call bring equal arrays as other objects (these
    # specs occur in no other test, so the plan memo holds none of them):
    # each distinct object is uploaded once and gathered into its rows
    later, _ = phrase.plan_phrase(
        _specs(NoteSpec, src, [("G4", 300, "t3")]), device="cpu")
    mixed = members + later
    assert mixed[2].arrays["env_cut"] is not mixed[0].arrays["env_cut"]
    tensors, _, _ = render_core.device_inputs(
        rs, [m.arrays for m in mixed], [m.scalars for m in mixed],
        [0, 1, 2], "cpu")
    for k in phrase.ARRAY_ORDER:
        np.testing.assert_array_equal(
            tensors[k].numpy(), np.stack([m.arrays[k] for m in mixed]), k)


# ---- the batched core vs goofer_tpu's vmapped core ---------------------

def _jax_group(rs, members, seed, scalars):
    """goofer_tpu's render_note_core under jax.vmap over a JAX-planned
    group, every array batched, keyed (seed, note index) as its
    render_phrase keys it."""
    stacked = [np.stack([np.asarray(m.arrays[k]) for m in members])
               for k in j_phrase.ARRAY_ORDER]
    sc = {k: np.stack([np.asarray(s.get(k, d), np.float32) for s in scalars])
          for k, d in j_default_scalars().items()}
    keys = np.stack([np.full(len(members), seed, np.uint32),
                     np.asarray([m.index for m in members], np.uint32)], 1)
    return _jax_vmapped_core(rs), (stacked, sc, keys)


@lru_cache(maxsize=None)
def _jax_vmapped_core(rs):
    """One jitted vmapped core per statics, so that the noise-zeroed and
    the noisy halves of a case share one compile."""
    return jax.jit(jax.vmap(partial(j_render_note_core, rs)))


def _port_group(rs, members, seed, scalars):
    rs_t, tensors, sc_t, keys = render_core.from_jax_plan(
        rs, [m.arrays for m in members], scalars, "cpu",
        seeds=[(seed, m.index) for m in members])
    out = render_core.render_note_core(
        rs_t, *(tensors[k] for k in render_core.ARRAY_KEYS), sc_t, keys)
    # the fry-overridden f0 the pulse layers integrate
    base_w = (render_core.fry_curves(rs_t, sc_t, "cpu")[0] if rs_t.fry_on
              else None)
    f0 = render_core.assemble_f0_mask(
        rs_t, tensors["f0_cut"], tensors["mask_cut"], base_w,
        tensors["pitch_ticks"], sc_t)[1]
    return out.numpy(), f0.numpy()


# the heavy stack without its two layers whose draws differ between the
# packages by design (sh/sr pitch and volume jitter, sj growl noise), so
# that the noise-zeroed half compares samples; the fry base moved from 50
# Hz to 73 Hz as tests/fixtures_common.py's fry config has it: at 50 Hz
# every fry period is exactly 882 samples, each fry onset a phase tie
# that either package may place a sample off (PARITY.md), and the whole
# fry span would fall out of the comparison
HEAVY_DET = HEAVY.replace("sh30sr30", "").replace("sj20", "") + "vh73"
GROUP_ROWS = {
    "exact": [("C4", 300, "t10"), ("E4", 300, "B20"), ("G3", 300, "t-30B-10")],
    "bucketed": [("C4", 300, "P0t10"), ("E4", 345, "P0B20"),
                 ("G3", 390, "P0t-30B-10")],
    "heavy": [("C4", 300, HEAVY_DET), ("E4", 300, HEAVY_DET + "t10"),
              ("G3", 300, HEAVY_DET + "t-20")],
}


def _keep_mask(rs, f0_t, f0_j, mask_j):
    """Samples outside the pulse windows whose onset may land a sample
    off, over every pulse layer of the group (main, su, sg: tests/
    test_resample_oracle.py:_layer_f0s)."""
    vib_t = vib_j = None
    if rs.add_subharm:
        vib_t = subharm_vibrato(torch.as_tensor(f0_t[None]), SR, 75.0, 3.0,
                                0.01)[0].numpy()
        vib_j = np.asarray(j_subharm_vibrato(
            jax.numpy.asarray(f0_j), SR, jax.numpy.float32(75.0),
            jax.numpy.float32(3.0), 0.01))
    return _flip_exclusion_mask(
        _layer_f0s(f0_t, mask_j, rs.su_on, rs.add_subharm, SR, vib_t),
        _layer_f0s(f0_j, mask_j, rs.su_on, rs.add_subharm, SR, vib_j),
        f0_j, SR, rs.n)


@pytest.mark.parametrize("case", sorted(GROUP_ROWS))
def test_batched_core_matches_jax_vmap(src, case):
    bucket = case == "bucketed"
    planned, _ = j_phrase.plan_phrase(
        _specs(j_phrase.NoteSpec, src, GROUP_ROWS[case]), bucket=bucket)
    (rs, _), members = next(iter(j_phrase.group_planned(planned).items()))
    assert len(members) == 3 and rs.masked == bucket

    quiet = [dict(m.scalars, uv_strength=0.0, breath_strength=0.0)
             for m in members]
    fn, (stacked, sc, keys) = _jax_group(rs, members, 0, quiet)
    want = np.asarray(fn(*stacked, sc, keys))
    got, f0_t = _port_group(rs, members, 0, quiet)
    assert got.shape == want.shape and np.isfinite(got).all()
    for b, m in enumerate(members):
        n_true = int(m.scalars["n_true"])
        # compared up to the true end; the bucketed tail differs by design
        # (module docstring) and both are zero past n_true
        n_cmp = n_true - N_FFT if bucket else n_true
        assert not got[b, n_true:].any() and not want[b, n_true:].any()
        f0_j, mask_j = _device_f0_mask(rs, m.arrays, quiet[b])
        keep = _keep_mask(rs, f0_t[b].astype(np.float64),
                          np.asarray(f0_j, np.float64), mask_j)[:n_cmp]
        assert keep.mean() > 0.9
        peak = float(np.abs(want[b]).max())
        d = np.abs(got[b, :n_cmp] - want[b, :n_cmp])[keep] / peak
        assert d.max() <= 5e-3, (b, d.max())
        assert lsd_db(got[b, :n_cmp], want[b, :n_cmp], SR, N_FFT, HOP) < 0.1

    # noise on: other RNGs, spectral parity against goofer_tpu's own
    # seed-to-seed distance
    loud = [dict(m.scalars) for m in members]
    fn, (stacked, sc, keys) = _jax_group(rs, members, 0, loud)
    want = np.asarray(fn(*stacked, sc, keys))
    keys1 = keys.copy()
    keys1[:, 0] = 1
    other = np.asarray(fn(*stacked, sc, keys1))
    got, _ = _port_group(rs, members, 0, loud)
    for b, m in enumerate(members):
        n_cmp = int(m.scalars["n_true"]) - (N_FFT if bucket else 0)
        floor = lsd_db(other[b, :n_cmp], want[b, :n_cmp], SR, N_FFT, HOP)
        lsd = lsd_db(got[b, :n_cmp], want[b, :n_cmp], SR, N_FFT, HOP)
        assert lsd <= max(1.0, floor + 0.5), (b, lsd, floor)


# ---- the port's phrase against itself ---------------------------------

PHRASE_ROWS = [("C4", 300, "t10"), ("A3", 420, HEAVY), ("E4", 300, "B20"),
               ("C5", 420, HEAVY + "t10"), ("G3", 300, "t-30B-10")]


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_phrase_row_equals_note_alone(src):
    """A note's waveform does not depend on the notes batched with it:
    the same (seed, index) key gives the same noise, so even the heavy
    stack's stochastic layers agree to float accuracy."""
    notes = _specs(NoteSpec, src, PHRASE_ROWS)
    outs = phrase.render_phrase(notes, seed=3, device="cpu")
    planned, _ = phrase.plan_phrase(notes, device="cpu")
    assert [len(ms) for ms in phrase.group_planned(planned).values()] == [3, 2]
    for pl, out in zip(planned, outs):
        alone = render_core.render_note(pl.rs, pl.arrays, pl.scalars,
                                        (3, pl.index), "cpu").numpy()
        assert out.shape == alone.shape == (pl.rs.n,)
        assert _rel(out, alone) <= 5e-3
        assert lsd_db(out, alone, SR, N_FFT, HOP) < 0.1
    # another index is another realization
    other = render_core.render_note(planned[0].rs, planned[0].arrays,
                                    planned[0].scalars, (3, 1), "cpu").numpy()
    assert _rel(other, outs[0]) > 1e-2


BUCKET_ROWS = [("C4", 300, "t10"), ("A3", 345, "B20"), ("E4", 390, "t-30B-10"),
               ("C5", 320, HEAVY.replace("sh30sr30", "")),
               ("G3", 410, HEAVY.replace("sh30sr30", "") + "t10")]


def test_bucketed_equals_exact(src):
    """Bucketed against bucket=False over each note's true extent, noise
    stems on (the frame-keyed phases repeat) but no jitter: 5e-3 x peak
    and 0.1 dB."""
    notes = _specs(NoteSpec, src, BUCKET_ROWS)
    planned, _ = phrase.plan_phrase(notes, bucket=True, device="cpu")
    assert len(phrase.group_planned(planned)) == 2
    exact = phrase.render_phrase(notes, bucket=False, device="cpu")
    padded = phrase.render_phrase(notes, bucket=True, device="cpu")
    for a, b in zip(padded, exact):
        assert a.shape == b.shape
        assert _rel(a, b) <= 5e-3
        assert lsd_db(a, b, SR, N_FFT, HOP) < 0.1


def test_bucketed_jitter_within_lsd_budget(src):
    """With sh/sr the smoothed jitter noise is blurred and peak-normalized
    over the padded length, so bucketed and exact renders are two
    realizations: <= 1 dB smoothed LSD."""
    notes = _specs(NoteSpec, src, [("C4", 300, "sh30sr30"),
                                   ("A3", 360, "sh30sr30")])
    exact = phrase.render_phrase(notes, bucket=False, device="cpu")
    padded = phrase.render_phrase(notes, bucket=True, device="cpu")
    for a, b in zip(padded, exact):
        assert a.shape == b.shape and np.isfinite(a).all()
        assert lsd_db(a, b, SR, N_FFT, HOP) <= 1.0


def test_outputs_order_pcm16_and_fetch(src):
    """Outputs come back in input order whatever the grouping; pcm16
    quantizes the float render; fetch=False returns None."""
    notes = _specs(NoteSpec, src, PHRASE_ROWS)
    outs = phrase.render_phrase(notes, device="cpu")
    want_n = [int(0.06 * SR) + int(length / 1000 * SR)
              for _, length, _ in PHRASE_ROWS]
    assert [len(o) for o in outs] == want_n
    pcm = phrase.render_phrase(notes, pcm16=True, device="cpu")
    for o, q in zip(outs, pcm):
        assert o.dtype == np.float32 and q.dtype == np.int16
        assert np.abs(o).max() > 1e-3
        want = np.round(np.clip(o, -1.0, 32767.0 / 32768.0) * 32768.0)
        np.testing.assert_array_equal(q, want.astype(np.int16))
    assert phrase.render_phrase(notes, fetch=False, device="cpu") is None


def test_group_launches_each_kernel_once_per_pass(src, monkeypatch):
    """A group of B notes calls each kernel wrapper once per pass with B
    rows (2B for the fry pair), as one note does with one row: the heavy
    stack has 4 pulse passes (main, sg, su, sj) and 5 cascades (su and sj
    layers, the fry pair, the two tension filters)."""
    calls = {"pulse": [], "cascade": []}
    real_pulse, real_cascade = pulse.pulse_accumulate, scan_iir.one_pole_cascade

    def count_pulse(f0, *args):
        calls["pulse"].append(f0.shape[0])
        return real_pulse(f0, *args)

    def count_cascade(x, *args):
        calls["cascade"].append(x.shape[0])
        return real_cascade(x, *args)

    monkeypatch.setattr(pulse, "pulse_accumulate", count_pulse)
    monkeypatch.setattr(scan_iir, "one_pole_cascade", count_cascade)
    notes = _specs(NoteSpec, src, [(p, 300, HEAVY) for p in ("G3", "C4",
                                                             "C5")])
    phrase.render_phrase(notes, device="cpu")
    assert calls == {"pulse": [3] * 4, "cascade": [3, 3, 6, 3, 3]}
    calls["pulse"].clear()
    calls["cascade"].clear()
    phrase.render_phrase(notes[:1], device="cpu")
    assert calls == {"pulse": [1] * 4, "cascade": [1, 1, 2, 1, 1]}


def test_render_phrase_to_wavs(src, tmp_path):
    from goofer_tpu_torch.utils.audio_io import read_wav

    notes = _specs(NoteSpec, src, PHRASE_ROWS[:2])
    paths = [tmp_path / f"{i}.wav" for i in range(2)]
    outs = phrase.render_phrase_to_wavs(notes, paths, device="cpu")
    for o, p in zip(outs, paths):
        y, sr = read_wav(p)
        assert sr == SR and len(y) == len(o)


def test_render_phrase_defaults_to_the_card(src, monkeypatch):
    """Without a device the phrase renders on CUDA or raises; it never
    falls back to the CPU on its own."""
    from goofer_tpu_torch import config

    monkeypatch.delenv(config.DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        phrase.render_phrase(_specs(NoteSpec, src, PHRASE_ROWS[:1]))
