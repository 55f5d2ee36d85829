"""The note render: everything between "features are cut" and "final
waveform".

Port of goofer_tpu/sampler/render_core.py (``render_note_core``):
envelope effects, loop/velocity plan materialization, formant strength
bells, the pitch curve, pitch-driven dynamics, vocal fry, the main
synthesis plus the su/sj/sa layers, fry highpass blending, sd dryness, st
tension and the V/B/U mix.  PyTorch runs eagerly, so there is no
compiled-graph machinery.

Where goofer_tpu vmaps one note's graph, ``render_note_core`` takes B
notes of one geometry: every array carries a leading batch axis, every
scalar is a (B,) float32 tensor (the two vectors (B, 4)), and every
branch on a scalar is tensor arithmetic.  ``RenderStatic`` carries the
shapes and branch toggles the batch shares.  The phrase renderer
(sampler/phrase.py) batches the notes of a group; ``render_note`` is the
same code at B = 1.  goofer_tpu's ``universal`` graph exists to bound XLA
compiles and its ``warp_band`` is an output-identical bound on a TPU
gather: eager PyTorch has neither cost, so RenderStatic has neither
field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from goofer_tpu_torch import config
from goofer_tpu_torch.engine.synth import (
    RENDER_STREAMS,
    SynthStatic,
    _synth_body,
)
from goofer_tpu_torch.ops import noise as rnd
from goofer_tpu_torch.ops.envelope import (
    brightness_tilt,
    env_shape,
    formant_strength_gain,
    formant_width_warp,
    fry_env_shift,
)
from goofer_tpu_torch.ops.filters import gaussian_blur1d, gaussian_kernel1d
from goofer_tpu_torch.ops.interp import gather_lerp
from goofer_tpu_torch.ops.jitter import volume_jitter
from goofer_tpu_torch.ops.scan_iir import dynamic_butter_filter
from goofer_tpu_torch.utils.profiling import count, traced


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
    # bucketed geometry: n / t_env are padded buckets; each note's true
    # length arrives as the scalar ``n_true`` and padding is masked out of
    # every normalization and of the final output
    masked: bool = False


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
        "tick_dt_samp": 1.0,
        "n_ticks": 1.0,
        # true output samples; 0 stands for RenderStatic.n
        "n_true": 0.0,
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


ARRAY_KEYS = ("env_cut", "f0_cut", "mask_cut", "env_pos0", "env_pos1",
              "env_w", "vel_env_pos", "tracks", "tracks_raw", "pitch_ticks")
# a note's random streams, columns of its key row: the main and the sa
# synthesis passes' streams, then the sj layer's pitch noise.  The su and
# sj passes draw nothing (no noise stems, no jitter).
KEYS_MAIN = slice(0, RENDER_STREAMS)
KEYS_SA = slice(RENDER_STREAMS, 2 * RENDER_STREAMS)
KEY_GROWL = 2 * RENDER_STREAMS
NOTE_STREAMS = 2 * RENDER_STREAMS + 1


def _apply_plan(src, pos0, pos1, w):
    """A frame plan (B, T') applied along the frames of (B, n_bins, T)."""
    a = gather_lerp(src, pos0, axis=-1)
    b = gather_lerp(src, pos1, axis=-1)
    w = w[:, None, :]
    return a * (1.0 - w) + b * w


def loop_positions(rs: RenderStatic, scalars, device) -> torch.Tensor:
    """(B, n_loop) integer sample positions of the sustain loop: identity
    prefix + tail tiling (ref SillySampler.py:698-712)."""
    j = torch.arange(rs.n_loop or rs.n, device=device)
    pre = torch.round(scalars["loop_pre"]).long()[:, None]
    tail = torch.clamp(torch.round(scalars["loop_tail"]).long(),
                       min=1)[:, None]
    return torch.where(j < pre, j, pre + torch.remainder(j - pre, tail))


def velocity_positions(rs: RenderStatic, scalars, device) -> torch.Tensor:
    """(B, n) fractional source positions of the consonant-velocity warp
    (plan.plan_prefix_stretch / ref SillySampler.py:176-187):
    pos = i/factor below pre_new, (i - pre_new) + pre_len above."""
    i = torch.arange(rs.n, dtype=torch.float32, device=device)
    pre_new = scalars["vel_pre_new"][:, None]
    return torch.where(i < pre_new, i / scalars["vel_factor"][:, None],
                       (i - pre_new) + scalars["vel_pre_len"][:, None])


def _fry_mask_at(sc, pos):
    """The faded fry-region mask at (float) sample positions, (m,) or
    (B, m) (ref: SillySampler.py:937-965; bounds from
    resampler._fry_scalars)."""
    c = {k: sc[k][:, None] for k in ("fry_s", "fry_e", "fry_a1", "fry_rin",
                                     "fry_b0", "fry_rout")}
    inside = ((pos >= c["fry_s"]) & (pos < c["fry_e"])).float()
    ramp_in = torch.where(pos < c["fry_a1"],
                          (pos - c["fry_s"]) * c["fry_rin"], 1.0)
    ramp_out = torch.where(pos >= c["fry_b0"],
                           1.0 - (pos - c["fry_b0"]) * c["fry_rout"], 1.0)
    return inside * ramp_in * ramp_out


def fry_curves(rs: RenderStatic, sc, device):
    """The fry base-pitch weight (B, n), region mask (B, n) and per-frame
    weight (B, t_env), materialized from the 12 host-derived scalars (the
    reference builds them as n-length arrays, SillySampler.py:883-996)."""
    j = torch.arange(rs.n, dtype=torch.float32, device=device)
    c0, c1, g0, g1, r0, rs_ = (sc[k][:, None] for k in (
        "fry_c0", "fry_c1", "fry_g0", "fry_g1", "fry_r0", "fry_rs"))
    base_w = (((j >= c0) & (j < c1)).float()
              + torch.where((j >= g0) & (j < g1), r0 + rs_ * (j - g0), 0.0))
    fry_mask = _fry_mask_at(sc, j)
    last = torch.clamp(sc["n_true"], min=1.0)[:, None] - 1.0
    centers = torch.minimum(
        torch.arange(rs.t_env, dtype=torch.float32, device=device) * rs.hop
        + rs.hop // 2, last)
    return base_w, fry_mask, _fry_mask_at(sc, centers)


def assemble_f0_mask(rs: RenderStatic, f0_cut, mask_cut, fry_base_w,
                     pitch_ticks, scalars):
    """The f0/voicing half of the render front: tick-curve
    interpolation, loop/velocity resampling, the Hz conversion gated by
    voicing and the fry pitch override (ref: SillySampler.py:835-855,
    883-935).  ``fry_base_w`` is fry_curves' base weight, or None when
    fry is off.  Returns (midi_curve, f0_new, mask_new), each (B, n)."""
    sc = scalars
    dev = f0_cut.device
    tick_pos = torch.minimum(
        torch.arange(rs.n, dtype=torch.float32, device=dev)
        / sc["tick_dt_samp"][:, None], sc["n_ticks"][:, None] - 1.0)
    midi_curve = gather_lerp(pitch_ticks.float(), tick_pos, axis=-1)
    lp = torch.clamp(loop_positions(rs, sc, dev), 0,
                     max(int(f0_cut.shape[-1]) - 1, 0))
    f0_new = torch.gather(f0_cut.float(), 1, lp)
    mask_new = torch.gather(mask_cut.float(), 1, lp)
    if rs.vel_on:
        vpos = velocity_positions(rs, sc, dev)
        f0_new = gather_lerp(f0_new, vpos, axis=-1)
        mask_new = gather_lerp(mask_new, vpos, axis=-1)
    hz_curve = 440.0 * 2.0 ** ((midi_curve - 69.0) / 12.0)
    f0_new = mask_new * hz_curve
    if rs.fry_on:
        fry_base = sc["fry_vh"][:, None] * (mask_new > 0).float()
        f0_new = (1.0 - fry_base_w) * f0_new + fry_base_w * fry_base
    return midi_curve, f0_new, mask_new


def _rms(x):
    return torch.sqrt(torch.mean(x ** 2, dim=-1, keepdim=True) + 1e-12)


def _tension(rs: RenderStatic, harmonic, aper_bre, f0_new, tension, sr):
    """st: tension (ref: SillySampler.py:1114-1140), the signed branches;
    each note's pair is rescaled to its RMS before the filters."""
    rms_before = _rms(harmonic + aper_bre)
    abs_ten = torch.abs(tension)
    if rs.tension_sign < 0:
        harmonic = dynamic_butter_filter(
            harmonic, f0_new, sr, 2.0 - abs_ten * 0.75,
            order=rs.tension_order, btype="lowpass")
        aper_bre = dynamic_butter_filter(
            aper_bre, f0_new, sr, abs_ten, order=4, btype="highpass")
    else:
        highpassed = dynamic_butter_filter(
            harmonic, f0_new, sr, abs_ten * 4, order=4, btype="highpass")
        harmonic = harmonic + highpassed * (1.0 + abs_ten[:, None] * 20.0)
        aper_bre = dynamic_butter_filter(
            aper_bre, f0_new, sr, (2.0 - abs_ten) / 0.5, order=6,
            btype="lowpass") * (1.0 - abs_ten[:, None])
    rms_after = _rms(harmonic + aper_bre)
    gain = torch.where(rms_after > 0, rms_before / rms_after, 1.0)
    return harmonic * gain, aper_bre * gain


def pd_sigma(sr: int) -> float:
    """The pd flag's bend blur, 10 ms (ref: SillySampler.py:862)."""
    return float(max(1, int(0.010 * sr)))


def pd_scale(rs: RenderStatic, pitch_ticks, scalars) -> torch.Tensor:
    """The pd flag's scale of each row, (B,) float32:
    ``np.percentile(|blur(curve - pd_baseline)|, 95) + 1e-8`` over the
    row's true length ``n_true``, the blur reflected at that end, as the
    reference plans it on the host (ref: SillySampler.py:857-866).

    The curve is interpolated and the baseline subtracted in float64, the
    baseline as its float32 column plus ``pd_baseline_lo``: a flat bend
    leaves only the baseline's float32 rounding, which float32 lerps
    would drown in their own.  The blur is the render's float32 blur,
    reflected by one gather at each row's ``n_true`` where rows are
    bucketed (``rs.masked``); the percentile is one sort of the rows,
    their padding sorted last, and a gather.  Enqueues only: counters
    ``render.pd_scale`` (rows) and ``render.pd_scale.reflected``."""
    sc = scalars
    dev = pitch_ticks.device
    b, n = pitch_ticks.shape[0], rs.n
    sigma = pd_sigma(rs.sr)

    def col64(name):
        return sc[name].double()[:, None]

    pos = torch.minimum(
        torch.arange(n, dtype=torch.float64, device=dev)
        / col64("tick_dt_samp"), col64("n_ticks") - 1.0)
    lo = pos.long()
    hi = torch.clamp(lo + 1, max=pitch_ticks.shape[-1] - 1)
    ticks = pitch_ticks.double()
    # exact where neighbouring ticks are equal, as np.interp is
    curve = torch.lerp(torch.gather(ticks, 1, lo), torch.gather(ticks, 1, hi),
                       pos - lo)
    bend = ((curve - col64("pd_baseline")) - col64("pd_baseline_lo")).float()
    n_true = sc["n_true"].long()[:, None]
    count("render.pd_scale", b)
    if rs.masked:
        # np.pad(mode="reflect") at n_true, over the blur's reach past it
        reach = n + len(gaussian_kernel1d(sigma)) // 2
        period = torch.clamp(2 * (n_true - 1), min=1)
        j = torch.remainder(torch.arange(reach, device=dev), period)
        bend = torch.gather(bend, 1, torch.where(j >= n_true, period - j, j))
        count("render.pd_scale.reflected", b)
    mag = torch.abs(gaussian_blur1d(bend, sigma)[:, :n])
    if rs.masked:
        mag = torch.where(torch.arange(n, device=dev) < n_true, mag,
                          float("inf"))
    ranked = torch.sort(mag, dim=-1).values
    # numpy's linear percentile at index q = 0.95 (n - 1), and its lerp
    q = 0.95 * (col64("n_true") - 1.0)
    at = q.long()
    v = torch.gather(ranked, 1, torch.cat(
        [at, torch.minimum(at + 1, n_true - 1)], dim=1)).double()
    return (torch.lerp(v[:, 0], v[:, 1], (q - at)[:, 0]) + 1e-8).float()


@traced("render.issue", notes=lambda rs, env_cut, *a, **k: env_cut.shape[0])
def render_note_core(rs: RenderStatic,
                     env_cut, f0_cut, mask_cut,
                     env_pos0, env_pos1, env_w,
                     vel_env_pos,
                     tracks, tracks_raw, pitch_ticks,
                     scalars: dict, keys: torch.Tensor) -> torch.Tensor:
    """B notes of one geometry in one pass; see the module docstring.
    Tensors are on one device, shaped per ``rs`` behind a leading batch
    axis (an array that the notes share may be one tensor expanded over
    it); ``scalars`` holds (B,) float32 tensors and the two (B, 4)
    tensors ``formant_band_shifts``/``formant_strengths``; ``keys``
    (B, NOTE_STREAMS) int64 keys every random stream of every note
    (``device_inputs`` prepares all three).  ``tracks`` are the sanitized
    + smoothed F1..F4 tracks (strength bells), ``tracks_raw`` the
    warp-anchor tracks.  Returns the (B, rs.n) float32 waveforms; with
    ``rs.masked`` each row is zero past its ``n_true``.  Only enqueues:
    the span ``render.issue``."""
    sr, n_fft, hop, n = rs.sr, rs.n_fft, rs.hop, rs.n
    sc = scalars
    dev = env_cut.device

    def col(name):
        return sc[name][:, None]

    fry_base_w = fry_mask = fry_frame_w = None
    if rs.fry_on:
        fry_base_w, fry_mask, fry_frame_w = fry_curves(rs, sc, dev)

    midi_curve, f0_new, mask_new = assemble_f0_mask(
        rs, f0_cut, mask_cut, fry_base_w, pitch_ticks, sc)

    env = env_cut.float()
    if rs.tilt_on:
        env = brightness_tilt(env, sc["brightness_env"], sr)
    if rs.shape_amt != 0.0:
        env = env_shape(env, rs.shape_amt)
    if rs.fw_on:
        env = formant_width_warp(env, sc["fw_amount"])

    env_new = _apply_plan(env, env_pos0, env_pos1, env_w)
    if rs.vel_on:
        env_new = gather_lerp(env_new, vel_env_pos, axis=-1)

    if rs.strengths_on:
        env_new = env_new * formant_strength_gain(
            env_new.shape[-2:], tracks, sc["formant_strengths"], sr)

    # pd: pitch-driven dynamics (ref: SillySampler.py:857-881), scaled
    # by each row's 95th percentile of the bend (pd_scale)
    dyn_gain = None
    if rs.pd_on:
        pd_bend = gaussian_blur1d(midi_curve - col("pd_baseline"),
                                  pd_sigma(sr))
        v = torch.clamp(pd_bend / pd_scale(rs, pitch_ticks, sc)[:, None],
                        -1.0, 1.0)
        signed = torch.where(col("pitch_dyn") > 0, v, -v)
        gain_db = 12.0 * torch.abs(col("pitch_dyn")) * signed
        dyn_gain = torch.clamp(10.0 ** (gain_db / 20.0), 1e-3, 1e3)
        vmask_s = gaussian_blur1d(mask_new, float(int(0.01 * sr)))
        dyn_gain = 1.0 + (dyn_gain - 1.0) * vmask_s

    # vocal fry envelope shift (the f0 override is in assemble_f0_mask;
    # ref: SillySampler.py:883-996)
    if rs.fry_on:
        env_new = fry_env_shift(env_new, fry_frame_w, 0.92)

    # ---- main synthesis ----------------------------------------------
    # the sg layer: one octave up under a 75 Hz, depth-3 vibrato faded in
    # over 10 ms (goofer_tpu/sampler/render_core.py:386-416)
    st_main = SynthStatic(
        sr=sr, n_fft=n_fft, hop=hop, n=n,
        f0_jitter=rs.f0_jitter,
        volume_jitter=rs.volume_jitter,
        add_subharm=rs.add_subharm,
        subharm_semitones=(12.0,),
        subharm_vibrato=True,
        subharm_vibrato_delay=0.01,
        cut_subharm_below_f0=True,
        warp_formants=rs.warp_formants,
        formant_shift_on=rs.formant_shift_on,
        max_overlap=rs.max_overlap,
        pulse_min_spacing=rs.min_spacing,
        subharm_min_spacing=rs.subharm_min_spacing,
        masked=rs.masked,
    )
    knobs = {
        "uv_strength": sc["uv_strength"],
        "breath_strength": sc["breath_strength"],
        "formant_shift": sc["formant_shift"],
        "formant_band_shifts": sc["formant_band_shifts"],
        "f0_jitter_strength": sc["f0_jitter_strength"],
        "volume_jitter_strength_harm": sc["volume_jitter_strength"],
        "volume_jitter_strength_breath": sc["volume_jitter_strength"] * 2,
        "subharm_weight": sc["subharm_weight"],
        "subharm_vibrato_rate": 75.0,
        "subharm_vibrato_depth": 3.0,
        "normalize": sc["normalize"],
        "n_true": sc["n_true"],
    }
    _, harmonic, aper_uv, aper_bre = _synth_body(
        st_main, env_new, f0_new, mask_new, tracks_raw, knobs,
        keys[:, KEYS_MAIN])

    # su and sj layer passes keep only their harmonic stem, and have no
    # jitter or subharmonics, so the main knobs serve them unchanged and
    # they draw from no stream
    def layer_harmonic(f0_layer, max_overlap, min_spacing):
        st_layer = SynthStatic(
            sr=sr, n_fft=n_fft, hop=hop, n=n,
            warp_formants=rs.warp_formants,
            formant_shift_on=rs.formant_shift_on,
            max_overlap=max_overlap,
            pulse_min_spacing=min_spacing,
            need_noise=False,
            masked=rs.masked,
        )
        _, harm, _, _ = _synth_body(st_layer, env_new, f0_layer, mask_new,
                                    tracks_raw, knobs, None)
        # the reference's order-6 highpass applied twice with the same
        # cutoffs is one order-12 cascade
        return dynamic_butter_filter(harm, torch.clamp(f0_new, min=120.0),
                                     sr, 1.0, order=12, btype="highpass")

    # su: sub-octave layer (ref: SillySampler.py:1037-1059)
    if rs.su_on:
        harm_sub = layer_harmonic(f0_new * 0.5, rs.max_overlap,
                                  rs.su_min_spacing)
        harmonic = harmonic + harm_sub * col("subharm_gain")

    # sj: growl layer at f0/2 under per-sample log-normal pitch noise
    # (ref: SillySampler.py:1061-1081)
    if rs.sj_on:
        growl = col("growl_mix")
        noise = growl ** 2 * rnd.normal(keys[:, KEY_GROWL], n)
        harm_gw = layer_harmonic(f0_new * (0.5 * 2.0 ** noise),
                                 rs.growl_max_overlap, rs.growl_min_spacing)
        harmonic = (1.0 - growl) * harmonic + growl * harm_gw

    # fry: highpass blend under the fry mask (ref: SillySampler.py:1083-1099).
    # The cutoff is a constant 200 Hz, so the 2B rows of the batch's
    # [harmonic, aper_bre] pairs share one (n,) coefficient row.
    if rs.fry_on:
        harm_hp, bre_hp = dynamic_butter_filter(
            torch.stack([harmonic, aper_bre]),
            torch.ones(n, dtype=torch.float32, device=dev), sr, 200.0,
            order=6, btype="highpass")
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
        aper_bre = aper_bre * (1.0 + (col("sd_strength") / 100.0) * 10)

    if rs.tension_sign != 0:
        harmonic, aper_bre = _tension(rs, harmonic, aper_bre, f0_new,
                                      sc["tension"], sr)

    out = (harmonic * col("harmonic_mix")
           + aper_bre * col("breathiness_mix")
           + aper_uv * col("unvoiced_mix")) * col("volume")

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
            masked=rs.masked,
        )
        # jitter and subharmonics are off in this pass, so only the
        # noise strengths differ from the main knobs
        ones = torch.ones_like(sc["uv_strength"])
        ap_knobs = dict(knobs, uv_strength=ones, breath_strength=ones)
        _, _, uv_u, bre_u = _synth_body(
            st_ap, env_new, f0_new, torch.ones_like(mask_new), tracks_raw,
            ap_knobs, keys[:, KEYS_SA])
        mix = col("aperiodic_mix")
        out = out * (1.0 - mix) + (uv_u + bre_u) * col("volume") * mix

    if dyn_gain is not None:
        out = out * dyn_gain
    if rs.masked:
        out = out * (torch.arange(n, dtype=torch.float32, device=dev)
                     < col("n_true")).float()
    return out


@traced("render.upload", notes=lambda rs, arrays, *a, **k: len(arrays))
def device_inputs(rs: RenderStatic, arrays: list, scalars: list, seeds: list,
                  device):
    """B notes' host planning output as ``render_note_core``'s batched
    inputs on ``device``: (tensors keyed like ARRAY_KEYS, scalars, keys).

    ``arrays`` and ``scalars`` hold one dict per note, ``seeds`` one seed
    per note (an int, or a tuple such as (seed, note index)).  An array
    that is the same object for several notes goes to the device once:
    expanded over the batch where every note shares it (goofer_tpu's
    in_axes=None case), else gathered there into its rows.  All
    scalars travel as one (B, S) float32 array, rounded as goofer_tpu
    traces them, and ``pd_baseline_lo`` beside them, the rounding of
    ``pd_baseline`` (for pd_scale).  The copies block: the span
    ``render.upload``."""
    b = len(arrays)
    tensors = {}
    for k in ARRAY_KEYS:
        # each distinct object goes to the device once
        slot: dict = {}
        rows = []
        for a in arrays:
            if slot.setdefault(id(a[k]), len(rows)) == len(rows):
                rows.append(np.asarray(a[k], np.float32))
        t = torch.as_tensor(np.stack(rows), device=device)
        if len(rows) == 1:
            t = t.expand(b, *t.shape[1:])
        elif len(rows) < b:
            t = t[torch.as_tensor([slot[id(a[k])] for a in arrays],
                                  device=device)]
        tensors[k] = t
    defaults = default_scalars()
    # the last column: what each float64 pd baseline loses to float32
    base = np.asarray([s.get("pd_baseline", 0.0) for s in scalars],
                      np.float64)
    packed = torch.as_tensor(np.concatenate([
        np.asarray([s.get(k, d) for s in scalars], np.float32).reshape(b, -1)
        for k, d in defaults.items()]
        + [(base - base.astype(np.float32)).astype(np.float32)[:, None]],
        axis=1), device=device)
    sc = {}
    at = 0
    for k, d in defaults.items():
        width = np.size(d)
        sc[k] = packed[:, at] if np.ndim(d) == 0 else packed[:, at:at + width]
        at += width
    sc["pd_baseline_lo"] = packed[:, at]
    sc["n_true"] = torch.where(sc["n_true"] > 0, sc["n_true"], float(rs.n))
    keys = torch.as_tensor(rnd.stream_keys(seeds, NOTE_STREAMS),
                           device=device)
    return tensors, sc, keys


def render_note(rs: RenderStatic, arrays: dict, scalars: dict, seed,
                device) -> torch.Tensor:
    """Single-note render from host planning output (``arrays`` of
    NumPy arrays keyed like render_note_core's signature, ``scalars``
    keyed like default_scalars) on ``device``: the batched render at
    B = 1.  ``seed`` is an int, or the (seed, note index) pair that keys
    the same note inside a phrase.  Returns the (n_true,) waveform."""
    tensors, sc, keys = device_inputs(rs, [arrays], [scalars], [seed], device)
    out = render_note_core(rs, *(tensors[k] for k in ARRAY_KEYS), sc, keys)
    return out[0, :int(scalars.get("n_true") or rs.n)]


def static_from_jax(rs) -> RenderStatic:
    """goofer_tpu's RenderStatic as this port's: the same fields less
    ``warp_band`` and ``universal`` (see the module docstring)."""
    if getattr(rs, "universal", False):
        raise ValueError("universal plans are not ported; use a specialized "
                         "plan (exact or bucketed)")
    return RenderStatic(**{f.name: getattr(rs, f.name)
                           for f in dataclasses.fields(RenderStatic)})


def from_jax_plan(rs, arrays, scalars, device, seeds=None):
    """Carry goofer_tpu plans across: the JAX ``RenderStatic`` and the
    NumPy arrays and scalars of ``GooferResampler.prepare()``, of one
    note (two dicts) or of a group sharing ``rs`` (two lists of dicts),
    become this port's RenderStatic and ``device_inputs``' batched
    tensors, scalars and keys (from ``seeds``, default 0 per note), so
    both ``render_note_core``s run on identical inputs, bucketed
    (``masked``) plans included."""
    rs_t = static_from_jax(rs)
    if isinstance(arrays, dict):
        arrays, scalars = [arrays], [scalars]
    seeds = [0] * len(arrays) if seeds is None else seeds
    return (rs_t,) + device_inputs(rs_t, arrays, scalars, seeds, device)
