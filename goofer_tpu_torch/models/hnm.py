"""Harmonic-plus-noise voice model: GOOFER-compatible library facade.

Port of goofer_tpu/models/hnm.py.  The function surface mirrors the
reference engine module (``extract_features``/``synthesize`` with the
same keyword arguments, ref: GOOFER.py:940-1220), so reference users can
port call sites unchanged; underneath, one note runs through the port's
synthesis pass (engine/synth.py) on ``config.get_device()``: CUDA unless
$GOOFER_TPU_TORCH_DEVICE names another device.  NumPy in, NumPy out.
"""
from __future__ import annotations

import numpy as np
import torch

from goofer_tpu_torch import config
from goofer_tpu_torch.analysis.features import extract_features  # noqa: F401
from goofer_tpu_torch.engine.synth import SynthStatic, synthesize as _synth
from goofer_tpu_torch.io.goofy import formants_to_int_keys, pad_trim_to_len
from goofer_tpu_torch.ops.envelope import decode_env_from_knots
from goofer_tpu_torch.ops.interp import resample_1d, resample_2d


def _stretch_all(env, env4b_placeholder, f0, mask, stretch, start_sec,
                 end_sec, sr, hop):
    """Whole-signal or span time stretch of features (ref:
    GOOFER.py:1019-1067), with the reference's ``int()`` truncations.
    ``env`` (n_bins, T), ``f0`` and ``mask`` (n,) tensors; the engine
    recomputes env4breath from the stretched envelope (blur and stretch
    are both linear)."""
    if start_sec is not None and end_sec is not None:
        s = int(start_sec * sr)
        e = int(end_sec * sr)
        seg_len = int((e - s) * stretch)
        f0 = torch.cat([f0[:s], resample_1d(f0[s:e], seg_len), f0[e:]])
        mask = torch.cat([mask[:s], resample_1d(mask[s:e], seg_len),
                          mask[e:]])
        sf = int((start_sec * sr) / hop)
        ef = int((end_sec * sr) / hop)
        seg_frames = int((ef - sf) * stretch)
        env = torch.cat([env[:, :sf], resample_2d(env[:, sf:ef], seg_frames),
                         env[:, ef:]], dim=1)
    else:
        f0 = resample_1d(f0, int(f0.shape[0] * stretch))
        mask = resample_1d(mask, int(mask.shape[0] * stretch))
        env = resample_2d(env, int(env.shape[1] * stretch))
    return env, f0, mask


def pulse_bounds(f0_interp, pitch_shift, sr, f0_jitter, f0_jitter_strength,
                 add_subharm, subharm_semitones, subharm_vibrato,
                 subharm_vibrato_depth, subharm_f0_jitter):
    """(max_overlap, pulse_min_spacing, subharm_min_spacing) for the
    pulse kernel's tables, from the f0 data as goofer_tpu derives them
    (goofer_tpu/models/hnm.py:105-134): pulses are zero past u ~= Ra +
    Rk (1 - Ra) = 0.804 of their period, onsets come at most f0_ceil/sr
    per sample, and the subharmonic layer runs ratio x (1 + vibrato
    depth) x (1 + jitter) denser."""
    f0_host = np.asarray(f0_interp, dtype=np.float64) * float(pitch_shift)
    pos = f0_host[f0_host > 1e-6]
    if pos.size:
        jit_hi = 1.0 + (f0_jitter_strength if f0_jitter else 0.0)
        jit_lo = max(0.25, 1.0 - (f0_jitter_strength if f0_jitter else 0.0))
        f0_ceil = max(pos.max() * jit_hi, 160.0)
        ratio = f0_ceil / max(1.0, min(pos.min() * jit_lo, 160.0))
    else:
        f0_ceil, ratio = 160.0, 1.0
    max_overlap = config.bucket_overlap(
        int(np.clip(np.ceil(0.804 * ratio) + 2, 3, 32)))
    min_spacing = config.bucket_min_spacing(int(sr / max(f0_ceil, 1.0)))
    if add_subharm:
        sub_ratio = max(2.0 ** (float(s_) / 12.0)
                        for s_ in subharm_semitones)
        sub_ceil = f0_ceil * max(sub_ratio, 1e-6)
        if subharm_vibrato:
            sub_ceil *= 1.0 + abs(float(subharm_vibrato_depth))
        if float(subharm_f0_jitter) > 0.0:
            sub_ceil *= 1.0 + abs(float(subharm_f0_jitter))
        subharm_min_spacing = config.bucket_min_spacing(
            int(sr / max(sub_ceil, 1.0)))
    else:
        subharm_min_spacing = 8
    return max_overlap, min_spacing, subharm_min_spacing


def synthesize(env_spec, f0_interp, voicing_mask, y, sr,
               n_fft=1024, hop_length=256, glottal_smoothing=False,
               stretch_factor=1.0, start_sec=None, end_sec=None,
               apply_brightness=True, normalize=1.0,
               uv_strength=0.75, breath_strength=0.1,
               noise_transition_smoothness=100,
               pitch_shift=1.0, formant_shift=1.0,
               f0_jitter=False, f0_jitter_speed=100,
               f0_jitter_strength=1.5,
               volume_jitter=False, volume_vibrato=False,
               volume_jitter_speed=150, volume_jitter_strength_harm=50,
               volume_jitter_strength_breath=100,
               add_subharm=False, subharm_semitones=-12,
               subharm_weight=0.5, subharm_vibrato=False,
               cut_subharm_below_f0=True, subharm_vibrato_rate=6.0,
               subharm_vibrato_depth=0.1, subharm_f0_jitter=0,
               subharm_vibrato_delay=0.1,
               F1_shift=1.0, F2_shift=1.0, F3_shift=1.0, F4_shift=1.0,
               formants=None,
               roughness_on=False, rough_k_list=(2, 3, 4),
               rough_h_list=None, rough_alpha=0.6, rough_hp_fc=320.0,
               rough_noise_amp=0.6, rough_noise_smooth_ms=120.0,
               rough_alpha_slew_ms=120.0,
               seed=0):
    """Drop-in equivalent of the reference synthesize
    (ref: GOOFER.py:971-1220).  ``y`` contributes only its length, as in
    goofer_tpu; ``seed`` keys every noise stream.  Returns NumPy
    (reconstruct, harmonic, aper_uv, aper_bre), fetched from the device
    in one copy."""
    device = config.get_device()
    if isinstance(env_spec, dict) and env_spec.get("mode") == "knots":
        env = decode_env_from_knots(
            torch.as_tensor(np.asarray(env_spec["knot_vals_log"],
                                       dtype=np.float32), device=device),
            env_spec["sr"], env_spec["n_fft"], env_spec["n_bins"])
    else:
        env = torch.as_tensor(np.asarray(env_spec, dtype=np.float32),
                              device=device)
    f0 = torch.as_tensor(np.asarray(f0_interp, dtype=np.float32),
                         device=device)
    mask = torch.as_tensor(np.asarray(voicing_mask, dtype=np.float32),
                           device=device)

    n_frames = env.shape[1]
    forms = formants_to_int_keys(formants)
    tracks = np.stack([pad_trim_to_len(forms[i], n_frames)
                       for i in (1, 2, 3, 4)]).astype(np.float32)

    if stretch_factor != 1.0:
        env, f0, mask = _stretch_all(env, None, f0, mask, stretch_factor,
                                     start_sec, end_sec, sr, hop_length)
    out_len = int(f0.shape[0])

    if not isinstance(subharm_semitones, (list, tuple, np.ndarray)):
        subharm_semitones = (float(subharm_semitones),)

    max_overlap, min_spacing, subharm_min_spacing = pulse_bounds(
        f0_interp, pitch_shift, sr, f0_jitter, f0_jitter_strength,
        add_subharm, subharm_semitones, subharm_vibrato,
        subharm_vibrato_depth, subharm_f0_jitter)

    st = SynthStatic(
        sr=int(sr), n_fft=n_fft, hop=hop_length, n=out_len,
        f0_jitter=bool(f0_jitter),
        f0_jitter_speed=float(f0_jitter_speed),
        volume_jitter=bool(volume_jitter),
        volume_vibrato=bool(volume_vibrato),
        volume_jitter_speed=float(volume_jitter_speed),
        add_subharm=bool(add_subharm),
        subharm_semitones=tuple(float(s) for s in subharm_semitones),
        subharm_vibrato=bool(subharm_vibrato),
        subharm_vibrato_delay=float(subharm_vibrato_delay),
        subharm_f0_jitter_on=float(subharm_f0_jitter) > 0.0,
        cut_subharm_below_f0=bool(cut_subharm_below_f0),
        warp_formants=any(s != 1.0 for s in
                          (F1_shift, F2_shift, F3_shift, F4_shift)),
        formant_shift_on=formant_shift != 1.0,
        apply_brightness=bool(apply_brightness),
        noise_transition_smoothness=float(noise_transition_smoothness),
        roughness_on=bool(roughness_on),
        rough_k_list=tuple(rough_k_list),
        rough_h_list=tuple(rough_h_list) if rough_h_list else None,
        rough_alpha=float(rough_alpha),
        rough_hp_fc=float(rough_hp_fc),
        rough_noise_amp=float(rough_noise_amp),
        rough_noise_smooth_ms=float(rough_noise_smooth_ms),
        rough_alpha_slew_ms=float(rough_alpha_slew_ms),
        max_overlap=max_overlap,
        pulse_min_spacing=min_spacing,
        subharm_min_spacing=subharm_min_spacing,
    )
    knobs = {
        "pitch_shift": pitch_shift,
        "formant_shift": formant_shift,
        "formant_band_shifts": np.asarray(
            [F1_shift, F2_shift, F3_shift, F4_shift], dtype=np.float32),
        "uv_strength": uv_strength,
        "breath_strength": breath_strength,
        "normalize": normalize,
        "f0_jitter_strength": f0_jitter_strength,
        "volume_jitter_strength_harm": volume_jitter_strength_harm,
        "volume_jitter_strength_breath": volume_jitter_strength_breath,
        "subharm_weight": subharm_weight,
        "subharm_vibrato_rate": subharm_vibrato_rate,
        "subharm_vibrato_depth": subharm_vibrato_depth,
        "subharm_f0_jitter_strength": subharm_f0_jitter,
    }
    stems = _synth(st, env, f0, mask, tracks, knobs, seed=seed,
                   device=device)
    out = torch.stack(stems).cpu().numpy()
    return out[0], out[1], out[2], out[3]
