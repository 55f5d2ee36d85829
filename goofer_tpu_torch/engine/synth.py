"""Harmonic-plus-noise resynthesis of one note.

Port of goofer_tpu/engine/synth.py (``_synth_body`` unmasked), mirroring
the reference resynthesis (ref: GOOFER.py:971-1220): LF pulse train ->
STFT -> f0-tracking sigmoid highpass -> envelope imposition with the
1..100 boost tilt -> brightness shelf + frequency blur on voiced frames ->
iSTFT, plus a random-phase noise branch split into breath (highpassed,
voiced-gated) and unvoiced (inverse-gated) stems, optional jitter and
subharmonic texture, and peak normalization ``gain = (1/peak) **
normalize``.  Only what the note render uses is here: the GOOFER-style
``synthesize`` entry and its extra options (roughness, brightness and
subharmonic switches) come with the models/hnm.py facade.

``SynthStatic`` holds the shape and branch configuration; ``knobs`` are
host scalars (Python floats) plus the (4,) band-shift tensor.  Random
streams come from a ``numpy.random.SeedSequence``: each stochastic stream
gets its own ``torch.Generator`` on the render's device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from goofer_tpu_torch import config
from goofer_tpu_torch.ops.envelope import (
    match_env_frames,
    shift_formants_global,
    warp_env_by_formants,
)
from goofer_tpu_torch.ops.filters import (
    gaussian_blur1d,
    gaussian_blur_complex_freq,
    smooth_mask_downsampled,
)
from goofer_tpu_torch.ops.jitter import (
    f0_jitter as make_f0_jitter,
    subharm_vibrato as apply_subharm_vibrato,
    volume_jitter as make_volume_jitter,
)
from goofer_tpu_torch.ops.pulse import pulse_train, subharm_pulse_train
from goofer_tpu_torch.ops.stft import istft, stft
from goofer_tpu_torch.ops.windows import (
    boost_curve,
    brightness_curves,
    rfft_freqs,
)


# Constants of the note render's synthesis passes (goofer_tpu passes them
# as SynthStatic fields and knobs from render_core.py:386-416): jitter
# speeds, and the sg layer one octave up under a 75 Hz, depth-3 vibrato
# faded in over 10 ms.
F0_JITTER_SPEED = 100.0
VOLUME_JITTER_SPEED = 150.0
SUBHARM_SEMITONES = (12.0,)
SUBHARM_VIBRATO_RATE = 75.0
SUBHARM_VIBRATO_DEPTH = 3.0
SUBHARM_VIBRATO_DELAY = 0.01


@dataclass(frozen=True)
class SynthStatic:
    """Shape and branch configuration of one synthesis pass."""
    sr: int
    n_fft: int = 1024
    hop: int = 256
    n: int = 0                       # output length in samples
    f0_jitter: bool = False
    volume_jitter: bool = False
    add_subharm: bool = False
    warp_formants: bool = False
    formant_shift_on: bool = False
    noise_transition_smoothness: float = 100.0
    # False skips the unvoiced stem.  For the sa aperiodic layer, which
    # synthesizes with an all-ones mask: upstream gates uv by
    # (1 - smooth(mask)) (GOOFER.py:1179-1183), structurally zero there.
    need_uv: bool = True
    max_overlap: int = config.PULSE_MAX_OVERLAP
    # assumed minimum pulse-onset spacing (samples); sizes the pulse
    # tables.  The subharmonic layer gets its own, host-derived.
    pulse_min_spacing: int = config.PULSE_MIN_SPACING
    subharm_min_spacing: int = 8


def default_knobs() -> dict:
    """Scalar parameters with the reference's defaults
    (ref: GOOFER.py:971-983)."""
    return {
        "formant_shift": 1.0,
        "formant_band_shifts": np.ones(4, dtype=np.float32),  # F1..F4
        "uv_strength": 0.75,
        "breath_strength": 0.1,
        "normalize": 1.0,
        "f0_jitter_strength": 1.5,
        "volume_jitter_strength_harm": 50.0,
        "volume_jitter_strength_breath": 100.0,
        "subharm_weight": 0.5,
    }


def make_generator(seed: np.random.SeedSequence,
                   device: torch.device) -> torch.Generator:
    """A torch.Generator on ``device`` seeded from ``seed``'s entropy."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return gen


def _synth_body(st: SynthStatic, env_spec: torch.Tensor,
                f0_interp: torch.Tensor, voicing_mask: torch.Tensor,
                formants_array: torch.Tensor, knobs: dict,
                seed: np.random.SeedSequence):
    """One synthesis pass; returns (mix, harmonic, aper_uv, aper_bre),
    each (st.n,) float32 on the inputs' device."""
    sr, n_fft, hop, n = st.sr, st.n_fft, st.hop, st.n
    dev = env_spec.device
    g_phase, g_f0j, g_vjh, g_vjb = (make_generator(s, dev)
                                    for s in seed.spawn(4))

    env_spec = env_spec.float()
    f0 = f0_interp.float()
    mask = voicing_mask.float()

    env4breath = gaussian_blur1d(env_spec, 1.75, axis=0)

    if st.warp_formants:
        bands = torch.as_tensor(knobs["formant_band_shifts"],
                                dtype=torch.float32, device=dev)
        shifted = formants_array * bands[:, None]
        env_spec = warp_env_by_formants(env_spec, formants_array, shifted, sr)
    if st.formant_shift_on:
        env_spec = shift_formants_global(env_spec, knobs["formant_shift"], sr)

    if st.f0_jitter:
        jit_track = make_f0_jitter(g_f0j, n, sr, F0_JITTER_SPEED,
                                   knobs["f0_jitter_strength"], dev)
        f0 = f0 * (1.0 + (jit_track - 1.0) * mask)

    pulse = pulse_train(f0, sr, max_overlap=st.max_overlap,
                        min_spacing=st.pulse_min_spacing)

    if st.add_subharm:
        f0_sub = apply_subharm_vibrato(
            f0, sr, SUBHARM_VIBRATO_RATE, SUBHARM_VIBRATO_DEPTH,
            SUBHARM_VIBRATO_DELAY)
        pulse = pulse + subharm_pulse_train(
            f0_sub, sr, mask, list(SUBHARM_SEMITONES),
            knobs["subharm_weight"], min_spacing=st.subharm_min_spacing)

    S_harm = stft(pulse, n_fft, hop)
    t_frames = S_harm.shape[1]

    freqs = torch.as_tensor(rfft_freqs(sr, n_fft), device=dev)  # (n_bins, 1)
    f0_frames = match_env_frames(f0[None, ::hop], t_frames)[0]
    hp_mask = 1.0 / (1.0 + torch.exp(
        -torch.clamp((freqs - f0_frames[None, :]) / 5.0, -60.0, 60.0)))

    S_harm = S_harm * hp_mask
    env_m = match_env_frames(env_spec, t_frames)

    mag_harm = torch.max(torch.abs(S_harm) + 1e-8)
    boost = torch.as_tensor(boost_curve(n_fft), device=dev)
    S_harm = (S_harm / mag_harm) * env_m * boost

    bright_harm, bright_breath = (torch.as_tensor(c, device=dev)
                                  for c in brightness_curves(sr, n_fft))
    voiced_frames = match_env_frames(mask[None, ::hop], t_frames)[0]
    voiced_cols = (voiced_frames > 0)[None, :]

    S_v = gaussian_blur_complex_freq(S_harm * bright_harm, 0.5)
    S_harm = torch.where(voiced_cols, S_v, S_harm)

    harmonic = istft(S_harm, hop, length=n)

    env_noise = match_env_frames(env4breath, t_frames)
    phi = 2.0 * math.pi * torch.rand(env_noise.shape, generator=g_phase,
                                     dtype=torch.float32, device=dev)
    S_uv = torch.complex(torch.cos(phi), torch.sin(phi)) * env_noise
    S_breath = S_uv * hp_mask
    S_bv = gaussian_blur_complex_freq(S_breath * bright_breath, 0.5)
    S_breath = torch.where(voiced_cols, S_bv, S_breath)

    aper_breath = istft(S_breath, hop, length=n)
    mask_smooth = smooth_mask_downsampled(
        mask, sigma=st.noise_transition_smoothness, ds=4)
    aper_bre = aper_breath * mask_smooth * knobs["breath_strength"]
    if st.need_uv:
        aper_uv = (istft(S_uv, hop, length=n) * (1.0 - mask_smooth)
                   * knobs["uv_strength"])
    else:
        aper_uv = torch.zeros_like(harmonic)

    if st.volume_jitter:
        hj = make_volume_jitter(g_vjh, n, sr, VOLUME_JITTER_SPEED,
                                knobs["volume_jitter_strength_harm"],
                                device=dev)
        bj = make_volume_jitter(g_vjb, n, sr, VOLUME_JITTER_SPEED,
                                knobs["volume_jitter_strength_breath"],
                                device=dev)
        vj_mask = gaussian_blur1d(mask, 20.0)
        harmonic = harmonic * (1.0 + (hj - 1.0) * vj_mask)
        aper_bre = aper_bre * (1.0 + (bj - 1.0) * vj_mask)

    combined = harmonic + aper_uv + aper_bre
    norm_amt = min(max(float(knobs["normalize"]), 0.0), 1.0)
    peak = torch.max(torch.abs(combined)) + 1e-12
    gain = (1.0 / peak) ** norm_amt
    return combined * gain, harmonic * gain, aper_uv * gain, aper_bre * gain
