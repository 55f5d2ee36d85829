"""The note render: everything between "features are cut" and "final
waveform".

Port of goofer_tpu/sampler/render_core.py (``render_note_core`` on an
exact-length ``RenderStatic``): envelope effects, loop/velocity plan
materialization, formant strength bells, the pitch curve, pitch-driven
dynamics, the main synthesis, the sd dryness and sa aperiodic layers and
the V/B/U mix.  PyTorch runs eagerly, so there is no compiled-graph
machinery: ``RenderStatic`` carries shapes and branch toggles, scalars
are host floats.

Not yet ported (they need the time-varying one-pole cascades of
goofer_tpu/ops/scan_iir.py): the su and sj layers, the vf/vh/vl fry
blend and st tension.  A plan that enables any of them raises
NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from goofer_tpu_torch import config
from goofer_tpu_torch.engine.synth import (
    SynthStatic,
    _synth_body,
    default_knobs,
)
from goofer_tpu_torch.ops.envelope import env_shape
from goofer_tpu_torch.ops.filters import gaussian_blur1d
from goofer_tpu_torch.ops.interp import gather_lerp, linspace
from goofer_tpu_torch.ops.jitter import volume_jitter

SCAN_IIR_ITEM = "the ops/scan_iir.py cascade-kernel item of ROADMAP.md"


@dataclass(frozen=True)
class RenderStatic:
    """Shapes and branch toggles of one note render."""
    sr: int
    n_fft: int
    hop: int
    n: int                       # output samples (post-velocity)
    t_env: int                   # envelope frames (post-velocity)
    # envelope effects (pre-loop)
    tilt_on: bool = False
    shape_amt: float = 0.0       # es value
    fw_on: bool = False
    # feature assembly
    vel_on: bool = False
    strengths_on: bool = False
    # pitch / dynamics / fry
    pd_on: bool = False
    fry_on: bool = False
    # main synth toggles
    f0_jitter: bool = False
    volume_jitter: bool = False
    add_subharm: bool = False
    warp_formants: bool = False
    formant_shift_on: bool = False
    # layers / post-fx
    su_on: bool = False
    sj_on: bool = False
    sd_on: bool = False
    tension_sign: int = 0        # -1 / 0 / +1
    sa_on: bool = False
    # pulse bounds, host-derived from the note's possible f0 range: K
    # most recent pulse generations per sample, and the minimum onset
    # spacing that sizes the pulse tables (see ops/pulse.py)
    max_overlap: int = config.PULSE_MAX_OVERLAP
    min_spacing: int = config.PULSE_MIN_SPACING
    subharm_min_spacing: int = 8
    # pre-velocity sample count (== n when vel_on is False)
    n_loop: int = 0


def default_scalars() -> dict:
    return {
        "brightness_env": 1.0,
        "fw_amount": 0.0,
        "formant_shift": 1.0,
        "formant_band_shifts": np.ones(4, dtype=np.float32),
        "formant_strengths": np.zeros(4, dtype=np.float32),
        "f0_jitter_strength": 0.0,
        "volume_jitter_strength": 0.0,
        "subharm_weight": 0.0,
        "normalize": 1.0,
        "pitch_dyn": 0.0,
        "pd_baseline": 0.0,
        "pd_ref": 1.0,
        "tick_dt_samp": 1.0,
        "n_ticks": 1.0,
        "sd_strength": 0.0,
        "harmonic_mix": 1.0,
        "breathiness_mix": 1.0,
        "unvoiced_mix": 1.0,
        "volume": 1.0,
        "aperiodic_mix": 0.0,
        # engine noise-strength knobs (ref synthesize defaults,
        # GOOFER.py:975); tests zero them to compare the deterministic
        # chain
        "uv_strength": 0.75,
        "breath_strength": 0.1,
        # loop/velocity geometry: closed forms rebuilt from these
        "loop_pre": 0.0,
        "loop_tail": 1.0,
        "vel_pre_new": 1.0,
        "vel_pre_len": 1.0,
        "vel_factor": 1.0,
    }


FORMANT_BELL_SIGMAS = (100.0, 200.0, 350.0, 500.0)
ARRAY_KEYS = ("env_cut", "f0_cut", "mask_cut", "env_pos0", "env_pos1",
              "env_w", "vel_env_pos", "tracks", "tracks_raw", "pitch_ticks")


def _strength_gain(n_bins, tracks, strengths, sr):
    """Formant strength bells (ref: SillySampler.py:791-833); zero
    strength is exactly unity gain."""
    freqs = linspace(0.0, sr / 2.0, n_bins, tracks.device)
    gain = torch.ones(n_bins, tracks.shape[1], device=tracks.device)
    for k in range(4):
        fk = tracks[k]
        ok = torch.isfinite(fk) & (fk > 50.0) & (fk < sr * 0.5)
        w = torch.exp(-0.5 * ((freqs[:, None] - fk[None, :])
                              / FORMANT_BELL_SIGMAS[k]) ** 2)
        gain = gain * (1.0 + strengths[k] * w * ok[None, :])
    return gain


def _tilt(env, brightness_env, sr):
    """Brightness tilt (ref: SillySampler.py:503-515)."""
    n_bins = env.shape[0]
    freqs = np.linspace(1e-6, sr * 0.5, n_bins, dtype=np.float32)
    norm_f = torch.as_tensor(np.clip(freqs / (sr * 0.5), 0.02, 1.0),
                             device=env.device)
    alpha = min(max(brightness_env - 1.0, -0.9), 1.0)
    tilt = norm_f ** alpha
    tilt = tilt / (torch.mean(tilt) + 1e-12)
    return env * tilt[:, None]


def _fw_warp(env, amount):
    """Formant width warp (ref: SillySampler.py:554-574): a shared row
    resample, the warp positions depend only on the bin."""
    n_bins = env.shape[0]
    bins = torch.arange(n_bins, dtype=torch.float32, device=env.device)
    center = n_bins / 2.0
    pos = torch.clamp((bins - center) * (1.0 + amount) + center,
                      0.0, n_bins - 1.0)
    return gather_lerp(env, pos, axis=0)


def _apply_plan(src, pos0, pos1, w, axis=-1):
    a = gather_lerp(src, pos0, axis=axis)
    b = gather_lerp(src, pos1, axis=axis)
    if src.ndim == 2 and axis in (1, -1):
        w = w[None, :]
    return a * (1.0 - w) + b * w


def loop_positions(rs: RenderStatic, scalars, device) -> torch.Tensor:
    """Integer sample positions of the sustain loop: identity prefix +
    tail tiling (ref SillySampler.py:698-712)."""
    j = torch.arange(rs.n_loop or rs.n, device=device)
    pre = int(round(scalars["loop_pre"]))
    tail = max(int(round(scalars["loop_tail"])), 1)
    return torch.where(j < pre, j, pre + torch.remainder(j - pre, tail))


def velocity_positions(rs: RenderStatic, scalars, device) -> torch.Tensor:
    """Fractional source positions of the consonant-velocity warp
    (plan.plan_prefix_stretch / ref SillySampler.py:176-187):
    pos = i/factor below pre_new, (i - pre_new) + pre_len above."""
    i = torch.arange(rs.n, dtype=torch.float32, device=device)
    pre_new = scalars["vel_pre_new"]
    return torch.where(i < pre_new, i / scalars["vel_factor"],
                       (i - pre_new) + scalars["vel_pre_len"])


def assemble_f0_mask(rs: RenderStatic, f0_cut, mask_cut, pitch_ticks,
                     scalars):
    """The f0/voicing half of the render front: tick-curve
    interpolation, loop/velocity resampling and the Hz conversion gated
    by voicing (ref: SillySampler.py:835-855).  Returns (midi_curve,
    f0_new, mask_new)."""
    sc = scalars
    dev = f0_cut.device
    tick_pos = torch.clamp(
        torch.arange(rs.n, dtype=torch.float32, device=dev)
        / sc["tick_dt_samp"], 0.0, sc["n_ticks"] - 1.0)
    midi_curve = gather_lerp(pitch_ticks.float(), tick_pos, axis=0)
    lp = torch.clamp(loop_positions(rs, sc, dev), 0,
                     max(int(f0_cut.shape[0]) - 1, 0))
    f0_new = f0_cut.float()[lp]
    mask_new = mask_cut.float()[lp]
    if rs.vel_on:
        vpos = velocity_positions(rs, sc, dev)
        f0_new = gather_lerp(f0_new, vpos, axis=0)
        mask_new = gather_lerp(mask_new, vpos, axis=0)
    hz_curve = 440.0 * 2.0 ** ((midi_curve - 69.0) / 12.0)
    return midi_curve, mask_new * hz_curve, mask_new


def check_supported(rs: RenderStatic) -> None:
    """Raise NotImplementedError for the branches this port lacks."""
    missing = [name for name, on in (
        ("su (sub-octave layer)", rs.su_on),
        ("sj (growl layer)", rs.sj_on),
        ("vf/vh/vl (vocal fry)", rs.fry_on),
        ("st (tension)", rs.tension_sign != 0)) if on]
    if missing:
        raise NotImplementedError(
            f"{', '.join(missing)} not ported yet: needs {SCAN_IIR_ITEM}")


def render_note_core(rs: RenderStatic,
                     env_cut, f0_cut, mask_cut,
                     env_pos0, env_pos1, env_w,
                     vel_env_pos,
                     tracks, tracks_raw, pitch_ticks,
                     scalars: dict, seed: int) -> torch.Tensor:
    """One note render; see the module docstring.  Tensors are on one
    device and shaped per ``rs``; ``scalars`` holds host floats and the
    two (4,) tensors ``formant_band_shifts``/``formant_strengths``
    (``render_note`` prepares them).  ``tracks`` are the sanitized +
    smoothed F1..F4 tracks (strength bells), ``tracks_raw`` the
    warp-anchor tracks.  ``seed`` seeds every random stream.  Returns the
    (rs.n,) float32 waveform."""
    check_supported(rs)
    sr, n_fft, hop, n = rs.sr, rs.n_fft, rs.hop, rs.n
    sc = scalars
    seed_main, seed_sa = np.random.SeedSequence(seed).spawn(2)

    midi_curve, f0_new, mask_new = assemble_f0_mask(
        rs, f0_cut, mask_cut, pitch_ticks, sc)

    env = env_cut.float()
    if rs.tilt_on:
        env = _tilt(env, sc["brightness_env"], sr)
    if rs.shape_amt != 0.0:
        env = env_shape(env, rs.shape_amt)
    if rs.fw_on:
        env = _fw_warp(env, sc["fw_amount"])

    env_new = _apply_plan(env, env_pos0, env_pos1, env_w, axis=-1)
    if rs.vel_on:
        env_new = gather_lerp(env_new, vel_env_pos, axis=-1)

    if rs.strengths_on:
        env_new = env_new * _strength_gain(env_new.shape[0], tracks,
                                           sc["formant_strengths"], sr)

    # pd: pitch-driven dynamics (ref: SillySampler.py:857-881); only the
    # 95th-percentile scale ``pd_ref`` comes from the host
    dyn_gain = None
    if rs.pd_on:
        pd_bend = gaussian_blur1d(midi_curve - sc["pd_baseline"],
                                  float(max(1, int(0.010 * sr))))
        v = torch.clamp(pd_bend / sc["pd_ref"], -1.0, 1.0)
        signed = v if sc["pitch_dyn"] > 0 else -v
        gain_db = 12.0 * abs(sc["pitch_dyn"]) * signed
        dyn_gain = torch.clamp(10.0 ** (gain_db / 20.0), 1e-3, 1e3)
        vmask_s = gaussian_blur1d(mask_new, float(int(0.01 * sr)))
        dyn_gain = 1.0 + (dyn_gain - 1.0) * vmask_s

    # ---- main synthesis ----------------------------------------------
    st_main = SynthStatic(
        sr=sr, n_fft=n_fft, hop=hop, n=n,
        f0_jitter=rs.f0_jitter,
        volume_jitter=rs.volume_jitter,
        add_subharm=rs.add_subharm,
        warp_formants=rs.warp_formants,
        formant_shift_on=rs.formant_shift_on,
        max_overlap=rs.max_overlap,
        pulse_min_spacing=rs.min_spacing,
        subharm_min_spacing=rs.subharm_min_spacing,
    )
    knobs = default_knobs()
    knobs.update({
        "uv_strength": sc["uv_strength"],
        "breath_strength": sc["breath_strength"],
        "formant_shift": sc["formant_shift"],
        "formant_band_shifts": sc["formant_band_shifts"],
        "f0_jitter_strength": sc["f0_jitter_strength"],
        "volume_jitter_strength_harm": sc["volume_jitter_strength"],
        "volume_jitter_strength_breath": sc["volume_jitter_strength"] * 2,
        "subharm_weight": sc["subharm_weight"],
        "normalize": sc["normalize"],
    })
    _, harmonic, aper_uv, aper_bre = _synth_body(
        st_main, env_new, f0_new, mask_new, tracks_raw, knobs, seed_main)

    # sd: dryness (ref: SillySampler.py:1101-1112); the vibrato form of
    # volume_jitter draws nothing
    if rs.sd_on:
        breath_j = volume_jitter(None, n, sr, speed=150.0,
                                 strength=sc["sd_strength"] / 200.0,
                                 vibrato=True, device=env_new.device)
        vmask_smooth = gaussian_blur1d(mask_new, 20.0)
        aper_bre = aper_bre * (1.0 + (breath_j - 1.0) * vmask_smooth)
        aper_bre = aper_bre * (1.0 + (sc["sd_strength"] / 100.0) * 10)

    out = (harmonic * sc["harmonic_mix"]
           + aper_bre * sc["breathiness_mix"]
           + aper_uv * sc["unvoiced_mix"]) * sc["volume"]

    # sa: uncorrelated aperiodic blend (ref: SillySampler.py:1153-1172)
    if rs.sa_on:
        st_ap = SynthStatic(
            sr=sr, n_fft=n_fft, hop=hop, n=n,
            warp_formants=rs.warp_formants,
            formant_shift_on=rs.formant_shift_on,
            noise_transition_smoothness=1.0,
            max_overlap=rs.max_overlap,
            pulse_min_spacing=rs.min_spacing,
            need_uv=False,
        )
        # jitter and subharmonics are off in this pass, so only the
        # noise strengths differ from the main knobs
        ap_knobs = dict(knobs, uv_strength=1.0, breath_strength=1.0)
        _, _, uv_u, bre_u = _synth_body(
            st_ap, env_new, f0_new, torch.ones_like(mask_new), tracks_raw,
            ap_knobs, seed_sa)
        mix = sc["aperiodic_mix"]
        out = out * (1.0 - mix) + (uv_u + bre_u) * sc["volume"] * mix

    if dyn_gain is not None:
        out = out * dyn_gain
    return out


def _f32(v):
    """A scalar as the float32 value goofer_tpu traces it as, or a
    float32 array for the vector scalars."""
    arr = np.asarray(v, dtype=np.float32)
    return float(arr) if arr.ndim == 0 else arr


def _device_inputs(arrays: dict, scalars: dict, device):
    full = default_scalars()
    full.update({k: v for k, v in scalars.items() if k in full})
    sc = {}
    for k, v in full.items():
        v = _f32(v)
        sc[k] = (torch.as_tensor(v, device=device)
                 if isinstance(v, np.ndarray) else v)
    tensors = {k: torch.as_tensor(np.ascontiguousarray(arrays[k], np.float32),
                                  device=device) for k in ARRAY_KEYS}
    return tensors, sc


def render_note(rs: RenderStatic, arrays: dict, scalars: dict, seed: int,
                device) -> torch.Tensor:
    """Single-note render from host planning output (``arrays`` of
    NumPy arrays keyed like render_note_core's signature, ``scalars``
    keyed like default_scalars) on ``device``."""
    tensors, sc = _device_inputs(arrays, scalars, device)
    return render_note_core(rs, *(tensors[k] for k in ARRAY_KEYS), sc, seed)


def from_jax_plan(rs, arrays: dict, scalars: dict, device):
    """Carry a goofer_tpu plan across: the JAX ``RenderStatic``, NumPy
    arrays and scalars of ``GooferResampler.prepare()`` become this
    port's RenderStatic, device tensors and scalars, so both
    ``render_note_core``s run on identical inputs.  Bucketed
    (``masked``) and universal plans have no counterpart here."""
    if getattr(rs, "masked", False) or getattr(rs, "universal", False):
        raise ValueError("bucketed/universal plans are not ported; use an "
                         "exact-length plan (prepare(..., bucket=False))")
    rs_t = RenderStatic(**{f.name: getattr(rs, f.name)
                           for f in dataclasses.fields(RenderStatic)})
    tensors, sc = _device_inputs(arrays, scalars, device)
    return rs_t, tensors, sc
