"""The note render: everything between "features are cut" and "final
waveform".

Port of goofer_tpu/sampler/render_core.py (``render_note_core`` on an
exact-length ``RenderStatic``): envelope effects, loop/velocity plan
materialization, formant strength bells, the pitch curve, pitch-driven
dynamics, vocal fry, the main synthesis plus the su/sj/sa layers, fry
highpass blending, sd dryness, st tension and the V/B/U mix.  PyTorch
runs eagerly, so there is no compiled-graph machinery: ``RenderStatic``
carries shapes and branch toggles, scalars are host floats.
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
    make_generator,
)
from goofer_tpu_torch.ops.envelope import env_shape, fry_env_shift
from goofer_tpu_torch.ops.filters import gaussian_blur1d
from goofer_tpu_torch.ops.interp import gather_lerp, linspace
from goofer_tpu_torch.ops.jitter import volume_jitter
from goofer_tpu_torch.ops.scan_iir import dynamic_butter_filter


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
    tension_order: int = 4       # LP order for tension < 0 (host-derived)
    sa_on: bool = False
    # pulse bounds, host-derived from the note's possible f0 range: K
    # most recent pulse generations per sample, and the minimum onset
    # spacing that sizes the pulse tables (see ops/pulse.py)
    max_overlap: int = config.PULSE_MAX_OVERLAP
    growl_max_overlap: int = config.PULSE_MAX_OVERLAP
    min_spacing: int = config.PULSE_MIN_SPACING
    growl_min_spacing: int = config.PULSE_MIN_SPACING
    subharm_min_spacing: int = 8
    su_min_spacing: int = config.PULSE_MIN_SPACING   # su runs at f0/2
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
        "fry_vh": 50.0,
        "subharm_gain": 0.0,
        "growl_mix": 0.0,
        "sd_strength": 0.0,
        "tension": 0.0,
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
        # fry curve bounds and slopes (resampler._fry_scalars); the
        # weight and mask ramps are materialized by fry_curves
        "fry_c0": 0.0, "fry_c1": 0.0, "fry_g0": 0.0, "fry_g1": 0.0,
        "fry_r0": 0.0, "fry_rs": 0.0, "fry_s": 0.0, "fry_e": 0.0,
        "fry_a1": 0.0, "fry_rin": 0.0, "fry_b0": 0.0, "fry_rout": 0.0,
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


def _fry_mask_at(sc, pos):
    """The faded fry-region mask at (float) sample positions
    (ref: SillySampler.py:937-965; bounds from resampler._fry_scalars)."""
    inside = ((pos >= sc["fry_s"]) & (pos < sc["fry_e"])).float()
    ramp_in = torch.where(pos < sc["fry_a1"],
                          (pos - sc["fry_s"]) * sc["fry_rin"], 1.0)
    ramp_out = torch.where(pos >= sc["fry_b0"],
                           1.0 - (pos - sc["fry_b0"]) * sc["fry_rout"], 1.0)
    return inside * ramp_in * ramp_out


def fry_curves(rs: RenderStatic, sc, device):
    """The fry base-pitch weight, region mask and per-frame weight,
    materialized from the 12 host-derived scalars (the reference builds
    them as n-length arrays, SillySampler.py:883-996)."""
    j = torch.arange(rs.n, dtype=torch.float32, device=device)
    base_w = (((j >= sc["fry_c0"]) & (j < sc["fry_c1"])).float()
              + torch.where((j >= sc["fry_g0"]) & (j < sc["fry_g1"]),
                            sc["fry_r0"] + sc["fry_rs"] * (j - sc["fry_g0"]),
                            0.0))
    fry_mask = _fry_mask_at(sc, j)
    centers = torch.clamp(
        torch.arange(rs.t_env, dtype=torch.float32, device=device) * rs.hop
        + rs.hop // 2, 0.0, max(rs.n, 1) - 1.0)
    return base_w, fry_mask, _fry_mask_at(sc, centers)


def assemble_f0_mask(rs: RenderStatic, f0_cut, mask_cut, fry_base_w,
                     pitch_ticks, scalars):
    """The f0/voicing half of the render front: tick-curve
    interpolation, loop/velocity resampling, the Hz conversion gated by
    voicing and the fry pitch override (ref: SillySampler.py:835-855,
    883-935).  ``fry_base_w`` is fry_curves' base weight, or None when
    fry is off.  Returns (midi_curve, f0_new, mask_new)."""
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
    f0_new = mask_new * hz_curve
    if rs.fry_on:
        fry_base = sc["fry_vh"] * (mask_new > 0).float()
        f0_new = (1.0 - fry_base_w) * f0_new + fry_base_w * fry_base
    return midi_curve, f0_new, mask_new


def _tension(rs: RenderStatic, harmonic, aper_bre, f0_new, tension, sr):
    """st: tension (ref: SillySampler.py:1114-1140), the signed branches;
    the pair is rescaled to its RMS before the filters."""
    rms_before = torch.sqrt(torch.mean((harmonic + aper_bre) ** 2) + 1e-12)
    abs_ten = abs(tension)
    if rs.tension_sign < 0:
        harmonic = dynamic_butter_filter(
            harmonic, f0_new, sr, 2.0 - abs_ten * 0.75,
            order=rs.tension_order, btype="lowpass")
        aper_bre = dynamic_butter_filter(
            aper_bre, f0_new, sr, abs_ten, order=4, btype="highpass")
    else:
        highpassed = dynamic_butter_filter(
            harmonic, f0_new, sr, abs_ten * 4, order=4, btype="highpass")
        harmonic = harmonic + highpassed * (1.0 + abs_ten * 20.0)
        aper_bre = dynamic_butter_filter(
            aper_bre, f0_new, sr, (2.0 - abs_ten) / 0.5, order=6,
            btype="lowpass") * (1.0 - abs_ten)
    rms_after = torch.sqrt(torch.mean((harmonic + aper_bre) ** 2) + 1e-12)
    gain = torch.where(rms_after > 0, rms_before / rms_after, 1.0)
    return harmonic * gain, aper_bre * gain


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
    sr, n_fft, hop, n = rs.sr, rs.n_fft, rs.hop, rs.n
    sc = scalars
    dev = env_cut.device
    # the first two streams predate the layers: renders without su/sj
    # keep their noise
    seed_main, seed_sa, seed_su, seed_sj, seed_growl = (
        np.random.SeedSequence(seed).spawn(5))

    fry_base_w = fry_mask = fry_frame_w = None
    if rs.fry_on:
        fry_base_w, fry_mask, fry_frame_w = fry_curves(rs, sc, dev)

    midi_curve, f0_new, mask_new = assemble_f0_mask(
        rs, f0_cut, mask_cut, fry_base_w, pitch_ticks, sc)

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

    # vocal fry envelope shift (the f0 override is in assemble_f0_mask;
    # ref: SillySampler.py:883-996)
    if rs.fry_on:
        env_new = fry_env_shift(env_new, fry_frame_w, 0.92)

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

    # su and sj layer passes keep only their harmonic stem, and have no
    # jitter or subharmonics, so the main knobs serve them unchanged
    def layer_harmonic(f0_layer, max_overlap, min_spacing, layer_seed):
        st_layer = SynthStatic(
            sr=sr, n_fft=n_fft, hop=hop, n=n,
            warp_formants=rs.warp_formants,
            formant_shift_on=rs.formant_shift_on,
            max_overlap=max_overlap,
            pulse_min_spacing=min_spacing,
            need_noise=False,
        )
        _, harm, _, _ = _synth_body(st_layer, env_new, f0_layer, mask_new,
                                    tracks_raw, knobs, layer_seed)
        # the reference's order-6 highpass applied twice with the same
        # cutoffs is one order-12 cascade
        return dynamic_butter_filter(harm, torch.clamp(f0_new, min=120.0),
                                     sr, 1.0, order=12, btype="highpass")

    # su: sub-octave layer (ref: SillySampler.py:1037-1059)
    if rs.su_on:
        harm_sub = layer_harmonic(f0_new * 0.5, rs.max_overlap,
                                  rs.su_min_spacing, seed_su)
        harmonic = harmonic + harm_sub * sc["subharm_gain"]

    # sj: growl layer at f0/2 under per-sample log-normal pitch noise
    # (ref: SillySampler.py:1061-1081)
    if rs.sj_on:
        growl = sc["growl_mix"]
        noise = growl ** 2 * torch.randn(
            n, generator=make_generator(seed_growl, dev),
            dtype=torch.float32, device=dev)
        harm_gw = layer_harmonic(f0_new * (0.5 * 2.0 ** noise),
                                 rs.growl_max_overlap, rs.growl_min_spacing,
                                 seed_sj)
        harmonic = (1.0 - growl) * harmonic + growl * harm_gw

    # fry: highpass blend under the fry mask (ref: SillySampler.py:1083-1099)
    if rs.fry_on:
        harm_hp, bre_hp = dynamic_butter_filter(
            torch.stack([harmonic, aper_bre]), torch.ones_like(f0_new), sr,
            200.0, order=6, btype="highpass")
        harmonic = harmonic * (1.0 - fry_mask) + harm_hp * fry_mask
        aper_bre = aper_bre * (1.0 - fry_mask) + bre_hp * fry_mask

    # sd: dryness (ref: SillySampler.py:1101-1112); the vibrato form of
    # volume_jitter draws nothing
    if rs.sd_on:
        breath_j = volume_jitter(None, n, sr, speed=150.0,
                                 strength=sc["sd_strength"] / 200.0,
                                 vibrato=True, device=dev)
        vmask_smooth = gaussian_blur1d(mask_new, 20.0)
        aper_bre = aper_bre * (1.0 + (breath_j - 1.0) * vmask_smooth)
        aper_bre = aper_bre * (1.0 + (sc["sd_strength"] / 100.0) * 10)

    if rs.tension_sign != 0:
        harmonic, aper_bre = _tension(rs, harmonic, aper_bre, f0_new,
                                      sc["tension"], sr)

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
