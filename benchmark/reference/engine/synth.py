"""Frozen copy of goofer_tpu_torch/engine/synth.py for the benchmark's plain reference:
the plain PyTorch versions of the hand kernels only.

Harmonic-plus-noise resynthesis of a batch of notes.

Port of goofer_tpu/engine/synth.py (``_synth_body``), mirroring the
reference resynthesis (ref: GOOFER.py:971-1220): LF pulse train ->
STFT -> f0-tracking sigmoid highpass -> envelope imposition with the
1..100 boost tilt -> brightness shelf + frequency blur on voiced frames ->
iSTFT, plus a random-phase noise branch split into breath (highpassed,
voiced-gated) and unvoiced (inverse-gated) stems, optional jitter,
vibrato, subharmonic and roughness texture, and peak normalization
``gain = (1/peak) ** normalize``.  ``synthesize`` is the host entry of
one note, for the models/hnm.py facade; the note render calls
``_synth_body`` with its own batch.

Where goofer_tpu vmaps one note's graph, every tensor here carries a
leading batch axis: B notes of one geometry go through each op, and
through each hand kernel, in one call.  ``SynthStatic`` holds the shape
and branch configuration shared by the batch; ``knobs`` are (B,) float32
tensors (one value per note), or floats shared by every note, plus the
(B, 4) band shifts; every reduction (spectral peak, subharmonic peak,
output peak) is per row.  Random streams are counter-based draws
(ops/noise.py) from ``keys`` (B, SYNTH_STREAMS) int64, one key per note
and stream, so a note's noise does not depend on the notes batched with
it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference import config
from benchmark.reference.ops import noise as rnd
from benchmark.reference.ops.envelope import (
    match_env_frames,
    shift_formants_global,
    warp_env_by_formants,
)
from benchmark.reference.ops.filters import (
    gaussian_blur1d,
    gaussian_blur_complex_freq,
    smooth_mask_downsampled,
)
from benchmark.reference.ops.jitter import (
    f0_jitter as make_f0_jitter,
    subharm_vibrato as apply_subharm_vibrato,
    vocal_roughness,
    volume_jitter as make_volume_jitter,
)
from benchmark.reference.ops.pulse import pulse_train, subharm_pulse_train
from benchmark.reference.ops.stft import istft, stft
from benchmark.reference.ops.windows import (
    boost_curve,
    brightness_curves,
    rfft_freqs,
)


@dataclass(frozen=True)
class SynthStatic:
    """Shape and branch configuration of one synthesis pass; the defaults
    are the reference's (ref: GOOFER.py:971-983)."""
    sr: int
    n_fft: int = 1024
    hop: int = 256
    n: int = 0                       # output length in samples
    f0_jitter: bool = False
    f0_jitter_speed: float = 100.0
    volume_jitter: bool = False
    volume_vibrato: bool = False
    volume_jitter_speed: float = 150.0
    add_subharm: bool = False
    subharm_semitones: tuple = (-12.0,)
    subharm_vibrato: bool = False
    subharm_vibrato_delay: float = 0.1
    subharm_f0_jitter_on: bool = False
    cut_subharm_below_f0: bool = True
    warp_formants: bool = False
    formant_shift_on: bool = False
    apply_brightness: bool = True
    noise_transition_smoothness: float = 100.0
    # False skips the whole aperiodic branch and returns zero noise
    # stems.  For the su/sj layer passes, whose callers keep only the
    # harmonic stem (SillySampler.py:1037-1081).  The peak normalization
    # then divides by peak(harmonic) instead of upstream's
    # peak(harmonic + the discarded noise stems), as goofer_tpu does.
    need_noise: bool = True
    # False skips the unvoiced stem.  For the sa aperiodic layer, which
    # synthesizes with an all-ones mask: upstream gates uv by
    # (1 - smooth(mask)) (GOOFER.py:1179-1183), structurally zero there.
    need_uv: bool = True
    roughness_on: bool = False
    rough_k_list: tuple = (2, 3, 4)
    rough_h_list: tuple | None = None
    rough_alpha: float = 0.6
    rough_hp_fc: float = 320.0
    rough_noise_amp: float = 0.6
    rough_noise_smooth_ms: float = 120.0
    rough_alpha_slew_ms: float = 120.0
    max_overlap: int = config.PULSE_MAX_OVERLAP
    # assumed minimum pulse-onset spacing (samples); sizes the pulse
    # tables.  The subharmonic layer runs up to ratio x (1 + vibrato
    # depth) x (1 + jitter strength) denser and gets its own, derived on
    # the host by the callers that know those values.
    pulse_min_spacing: int = config.PULSE_MIN_SPACING
    subharm_min_spacing: int = 8
    # bucketed rendering: ``n`` is a padded length bucket and each note's
    # true length rides in as the knob ``n_true``; excitation, spectral
    # frames and stems past it are zeroed before any normalization, so
    # notes of different true lengths share one batched pass
    masked: bool = False


def default_knobs() -> dict:
    """Per-note scalar parameters with the reference's defaults
    (ref: GOOFER.py:971-983)."""
    return {
        "pitch_shift": 1.0,
        "formant_shift": 1.0,
        "formant_band_shifts": np.ones(4, dtype=np.float32),  # F1..F4
        "uv_strength": 0.75,
        "breath_strength": 0.1,
        "normalize": 1.0,
        "f0_jitter_strength": 1.5,
        "volume_jitter_strength_harm": 50.0,
        "volume_jitter_strength_breath": 100.0,
        "subharm_weight": 0.5,
        "subharm_vibrato_rate": 6.0,
        "subharm_vibrato_depth": 0.1,
        "subharm_f0_jitter_strength": 0.0,
    }


# the random streams of one synthesis pass, columns of ``keys``.  The
# note render's passes draw from the first RENDER_STREAMS only (it never
# jitters the subharmonic f0 nor adds roughness), so its keys keep their
# columns.
(STREAM_PHASE, STREAM_F0_JITTER, STREAM_VJ_HARM, STREAM_VJ_BREATH,
 STREAM_SUBHARM_JITTER, STREAM_ROUGHNESS) = range(6)
RENDER_STREAMS = 4
SYNTH_STREAMS = 6


def _frame_phases(keys: torch.Tensor, n_bins: int,
                  t_frames: int) -> torch.Tensor:
    """(B, n_bins, T) uniform [0, 2 pi) phases.  Frame f's bins are draws
    f * n_bins .. (f + 1) * n_bins - 1 of the row's key, so they do not
    depend on the frame count: a bucket-padded render draws the same
    noise on its true frames as the unpadded one
    (goofer_tpu/engine/synth.py:_frame_phases)."""
    u = rnd.uniform(keys, t_frames * n_bins)
    return (2.0 * math.pi) * u.reshape(-1, t_frames, n_bins).transpose(1, 2)


def _synth_body(st: SynthStatic, env_spec: torch.Tensor,
                f0_interp: torch.Tensor, voicing_mask: torch.Tensor,
                formants_array: torch.Tensor, knobs: dict,
                keys: torch.Tensor | None):
    """One synthesis pass over B notes: ``env_spec`` (B, n_bins, T),
    ``f0_interp`` and ``voicing_mask`` (B, st.n), ``formants_array``
    (B, 4, T), ``knobs`` of (B,) tensors or floats (``formant_shift``,
    ``uv_strength``, ``breath_strength``, ``normalize``,
    ``f0_jitter_strength``, ``volume_jitter_strength_harm`` / ``_breath``,
    ``subharm_weight``, ``subharm_vibrato_rate`` / ``_depth``,
    ``subharm_f0_jitter_strength``, ``n_true``; default_knobs) and the
    (B, 4) ``formant_band_shifts``, ``keys`` (B, k) int64 with a column
    for each stream the pass draws from (None for a pass that draws
    nothing: no noise stems, no jitter, no roughness).  The pitch shift
    is the caller's (``synthesize`` applies it).  Returns (mix,
    harmonic, aper_uv, aper_bre), each (B, st.n) float32 on the inputs'
    device."""
    sr, n_fft, hop, n = st.sr, st.n_fft, st.hop, st.n
    dev = env_spec.device

    env_spec = env_spec.float()
    f0 = f0_interp.float()
    mask = voicing_mask.float()

    # Bucketed rendering (st.masked): the pass runs on the padded length
    # ``n`` while each row's true length is the knob ``n_true``.
    # Reproducing the unpadded pass takes four cuts:
    #   * the excitation is zeroed past n_true and the stft's right
    #     reflect pad at the TRUE end is written in (the magnitude
    #     normalization sees mirrored pulses in its last frames);
    #   * spectral frames past the true frame count are zeroed before the
    #     magnitude reduction and the iSTFTs;
    #   * stems are zeroed past hop * (n_true // hop), where the unpadded
    #     iSTFT's overlap-add ends and zero padding begins;
    #   * each iSTFT normalizes a row by the window sum of its true frames
    #     (ops/stft.py:istft).  goofer_tpu divides by the padded frames'
    #     sum, which attenuates the last n_fft samples before the true
    #     end; where the note's peak lies there, its peak normalization
    #     then scales the whole note (by up to ~10%).
    valid_in = valid_out = frame_valid = n_true_i = tf_true = None
    if st.masked:
        n_true_i = torch.round(knobs["n_true"]).long()[:, None]
        idx = torch.arange(n, device=dev)
        valid_in = (idx < n_true_i).float()
        valid_out = (idx < hop * (n_true_i // hop)).float()

    env4breath = (gaussian_blur1d(env_spec, 1.75, axis=-2)
                  if st.need_noise else None)

    if st.warp_formants:
        shifted = formants_array * knobs["formant_band_shifts"][:, :, None]
        env_spec = warp_env_by_formants(env_spec, formants_array, shifted, sr)
    if st.formant_shift_on:
        env_spec = shift_formants_global(env_spec, knobs["formant_shift"], sr)

    if st.f0_jitter:
        jit_track = make_f0_jitter(keys[:, STREAM_F0_JITTER], n, sr,
                                   st.f0_jitter_speed,
                                   knobs["f0_jitter_strength"])
        f0 = f0 * (1.0 + (jit_track - 1.0) * mask)

    pulse = pulse_train(f0, sr, max_overlap=st.max_overlap,
                        min_spacing=st.pulse_min_spacing)

    if st.add_subharm:
        f0_sub = f0
        if st.subharm_f0_jitter_on:
            sj = make_f0_jitter(keys[:, STREAM_SUBHARM_JITTER], n, sr,
                                st.f0_jitter_speed,
                                knobs["subharm_f0_jitter_strength"])
            f0_sub = f0_sub * (1.0 + (sj - 1.0) * mask)
        if st.subharm_vibrato:
            f0_sub = apply_subharm_vibrato(
                f0_sub, sr, knobs["subharm_vibrato_rate"],
                knobs["subharm_vibrato_depth"], st.subharm_vibrato_delay)
        sub_mask = mask * valid_in if st.masked else mask
        pulse = pulse + subharm_pulse_train(
            f0_sub, sr, sub_mask, list(st.subharm_semitones),
            knobs["subharm_weight"], min_spacing=st.subharm_min_spacing)

    if st.masked:
        # padded[n_true + k] = pulse[n_true - 2 - k]: a per-row scatter
        # where goofer_tpu has dynamic_update_slice, whose start clamps so
        # that the slice fits; resampler._bucketize leaves n_fft // 2 of
        # room past n_true
        pulse = pulse * valid_in
        k = torch.arange(n_fft // 2, device=dev)
        src = torch.clamp(n_true_i - 2 - k, 0, n - 1)
        dst = torch.clamp(n_true_i, max=n - n_fft // 2) + k
        pulse = pulse.scatter(1, dst, torch.gather(pulse, 1, src))

    S_harm = stft(pulse, n_fft, hop)
    t_frames = S_harm.shape[-1]

    if st.masked:
        # the unpadded stft has 1 + n_true // hop frames
        tf_true = 1 + n_true_i // hop
        frame_valid = (torch.arange(t_frames, device=dev)
                       < tf_true).float()[:, None, :]
        S_harm = S_harm * frame_valid

    freqs = torch.as_tensor(rfft_freqs(sr, n_fft), device=dev)  # (n_bins, 1)
    f0_frames = match_env_frames(f0[:, ::hop], t_frames)
    hp_mask = 1.0 / (1.0 + torch.exp(
        -torch.clamp((freqs - f0_frames[:, None, :]) / 5.0, -60.0, 60.0)))

    if st.cut_subharm_below_f0:
        S_harm = S_harm * hp_mask
    env_m = match_env_frames(env_spec, t_frames)

    mag_harm = torch.amax(torch.abs(S_harm) + 1e-8, dim=(-2, -1),
                          keepdim=True)
    boost = torch.as_tensor(boost_curve(n_fft), device=dev)
    S_harm = (S_harm / mag_harm) * env_m * boost

    bright_harm, bright_breath = (torch.as_tensor(c, device=dev)
                                  for c in brightness_curves(sr, n_fft))
    voiced_frames = match_env_frames(mask[:, ::hop], t_frames)
    voiced_cols = (voiced_frames > 0)[:, None, :]

    if st.apply_brightness:
        S_v = gaussian_blur_complex_freq(S_harm * bright_harm, 0.5)
        S_harm = torch.where(voiced_cols, S_v, S_harm)

    harmonic = istft(S_harm, hop, n, tf_true)

    if st.need_noise:
        env_noise = match_env_frames(env4breath, t_frames)
        phi = _frame_phases(keys[:, STREAM_PHASE], env_noise.shape[-2],
                            t_frames)
        S_uv = torch.complex(torch.cos(phi), torch.sin(phi)) * env_noise
        if st.masked:
            S_uv = S_uv * frame_valid
        S_breath = S_uv * hp_mask
        if st.apply_brightness:
            S_bv = gaussian_blur_complex_freq(S_breath * bright_breath, 0.5)
            S_breath = torch.where(voiced_cols, S_bv, S_breath)

        aper_breath = istft(S_breath, hop, n, tf_true)
        mask_smooth = smooth_mask_downsampled(
            mask, sigma=st.noise_transition_smoothness, ds=4)
        aper_bre = (aper_breath * mask_smooth
                    * knobs["breath_strength"][:, None])
        if st.need_uv:
            aper_uv = (istft(S_uv, hop, n, tf_true) * (1.0 - mask_smooth)
                       * knobs["uv_strength"][:, None])
        else:
            aper_uv = torch.zeros_like(harmonic)
    else:
        aper_bre = torch.zeros_like(harmonic)
        aper_uv = torch.zeros_like(harmonic)

    if st.volume_jitter:
        hj = make_volume_jitter(keys[:, STREAM_VJ_HARM], n, sr,
                                st.volume_jitter_speed,
                                knobs["volume_jitter_strength_harm"],
                                st.volume_vibrato, dev)
        bj = make_volume_jitter(keys[:, STREAM_VJ_BREATH], n, sr,
                                st.volume_jitter_speed,
                                knobs["volume_jitter_strength_breath"],
                                st.volume_vibrato, dev)
        vj_mask = gaussian_blur1d(mask, 20.0)
        harmonic = harmonic * (1.0 + (hj - 1.0) * vj_mask)
        aper_bre = aper_bre * (1.0 + (bj - 1.0) * vj_mask)

    if st.masked:
        harmonic = harmonic * valid_out
        aper_uv = aper_uv * valid_out
        aper_bre = aper_bre * valid_out

    combined = harmonic + aper_uv + aper_bre

    if st.roughness_on:
        harmonic_rough = vocal_roughness(
            keys[:, STREAM_ROUGHNESS], harmonic, f0, mask, sr,
            k_list=st.rough_k_list, h_list=st.rough_h_list,
            alpha=st.rough_alpha, hp_fc=st.rough_hp_fc,
            noise_amp=st.rough_noise_amp,
            noise_smooth_ms=st.rough_noise_smooth_ms,
            alpha_slew_ms=st.rough_alpha_slew_ms)
        if st.masked:
            harmonic_rough = harmonic_rough * valid_out
        combined = harmonic_rough + aper_uv + aper_bre

    norm_amt = torch.clamp(knobs["normalize"], 0.0, 1.0)[:, None]
    peak = torch.amax(torch.abs(combined), dim=-1, keepdim=True) + 1e-12
    gain = (1.0 / peak) ** norm_amt
    return combined * gain, harmonic * gain, aper_uv * gain, aper_bre * gain


def synthesize(st: SynthStatic, env_spec, f0_interp, voicing_mask,
               formants_array=None, knobs: dict | None = None, seed=0,
               device=None):
    """Host entry for one note: ``env_spec`` dense (n_bins, T),
    ``f0_interp`` and ``voicing_mask`` (st.n,), ``formants_array``
    (4, T) or None (arrays or tensors), ``knobs`` over default_knobs(), ``seed`` an int or a
    tuple of ints keying every random stream.  Runs on ``device`` (None:
    config.get_device()) and returns (mix, harmonic, aper_uv, aper_bre),
    each an (st.n,) float32 tensor there."""
    if st.n == 0:
        raise ValueError("SynthStatic.n (output length) must be set")
    device = config.get_device(device)
    full = default_knobs()
    if knobs:
        full.update(knobs)

    def row(x):
        if isinstance(x, torch.Tensor):
            return x.to(device, torch.float32)[None]
        return torch.as_tensor(np.asarray(x, dtype=np.float32),
                               device=device)[None]

    env = row(env_spec)
    if formants_array is None:
        formants_array = np.zeros((4, env.shape[-1]), dtype=np.float32)
    k = {name: row(v) for name, v in full.items()}
    keys = torch.as_tensor(rnd.stream_keys([seed], SYNTH_STREAMS),
                           device=device)
    f0 = row(f0_interp) * k.pop("pitch_shift")[:, None]
    stems = _synth_body(st, env, f0, row(voicing_mask), row(formants_array),
                        k, keys)
    return tuple(x[0] for x in stems)
