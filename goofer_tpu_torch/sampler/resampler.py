"""Note renderer: the UTAU resample pipeline.

Port of goofer_tpu/sampler/resampler.py (``GooferResampler``,
ref: SillySampler.py:415-1185).  The host computes index plans, formant
sanitization, the pitch curve and the pulse bounds (small NumPy work, the
same code as goofer_tpu); the render itself (sampler/render_core.py)
runs as PyTorch on the chosen device.

Scope of this slice: features come from an existing ``.goofy`` only
(analysis is not ported), and the su, sj, vf and st flags raise
NotImplementedError (they need the one-pole cascades of scan_iir).
"""
from __future__ import annotations

import logging
import math
from pathlib import Path

import numpy as np
import torch

from goofer_tpu_torch import config
from goofer_tpu_torch.io.goofy import formants_to_int_keys, load_features
from goofer_tpu_torch.ops.envelope import decode_env_from_knots
from goofer_tpu_torch.ops.filters import gaussian_kernel1d
from goofer_tpu_torch.sampler.flags import NoteParams
from goofer_tpu_torch.sampler.plan import (
    FramePlan,
    plan_cut,
    plan_env_loop,
    plan_prefix_stretch,
    plan_track_loop,
)
from goofer_tpu_torch.sampler.render_core import (
    SCAN_IIR_ITEM,
    RenderStatic,
    render_note,
)
from goofer_tpu_torch.utils.audio_io import write_wav

log = logging.getLogger("goofer_tpu_torch")

SANITIZE_MIN_HZ = (120.0, 300.0, 1500.0, 2000.0)


def _np_lerp_at(src: np.ndarray, pos: np.ndarray) -> np.ndarray:
    n = len(src)
    pos = np.clip(np.asarray(pos, dtype=np.float64), 0.0, n - 1.0)
    lo = np.clip(np.floor(pos).astype(np.int64), 0, max(n - 2, 0))
    frac = pos - lo
    hi = np.minimum(lo + 1, n - 1)
    return src[lo] * (1.0 - frac) + src[hi] * frac


def _np_apply_plan(src: np.ndarray, plan: FramePlan) -> np.ndarray:
    """Host materialization of a 1-D frame plan (for tiny formant tracks)."""
    a = _np_lerp_at(src, plan.pos0)
    b = _np_lerp_at(src, plan.pos1)
    return (a * (1.0 - plan.w) + b * plan.w).astype(np.float32)


def _np_fit(x: np.ndarray, t: int) -> np.ndarray:
    x = np.asarray(x, dtype=np.float32)
    if len(x) < t:
        return np.pad(x, (0, t - len(x)), mode="edge")
    return x[:t]


def _np_gaussian1d(x: np.ndarray, sigma: float) -> np.ndarray:
    """Reference-style Gaussian smoothing on host (reflect pad); switches
    to an FFT convolution for large taps*length products."""
    if sigma <= 0 or x.size == 0:
        return x.copy()
    k = gaussian_kernel1d(float(sigma)).astype(np.float64)
    radius = (len(k) - 1) // 2
    if radius <= 0:
        return x.copy()
    padded = np.pad(x.astype(np.float64), radius, mode="reflect")
    if len(k) * len(padded) > 4_000_000:
        n = len(padded)
        nfft = 1 << (n + len(k) - 2).bit_length()
        full = np.fft.irfft(np.fft.rfft(padded, nfft)
                            * np.fft.rfft(k, nfft), nfft)
        return full[len(k) - 1: len(k) - 1 + n - len(k) + 1]
    return np.convolve(padded, k, mode="valid")


def sanitize_formant_track(track: np.ndarray, t: int, sr: int,
                           min_hz: float, max_hz: float | None = None,
                           sigma_frames: float = 3) -> np.ndarray:
    """Repair out-of-range/NaN formant frames by interpolating from good
    ones, then smooth (ref: SillySampler.py:264-283)."""
    max_hz = max_hz or (sr * 0.48)
    x = np.array(track, dtype=np.float32, copy=True)
    if len(x) < t:
        x = np.pad(x, (0, t - len(x)), mode="edge")
    elif len(x) > t:
        x = x[:t]
    bad = (~np.isfinite(x)) | (x < min_hz) | (x > max_hz)
    if np.any(bad):
        good = np.where(~bad)[0]
        if good.size >= 2:
            gx = good.astype(np.float64)
            gy = x[~bad].astype(np.float64)
            pos = np.where(bad)[0].astype(np.float64)
            vals = np.interp(pos, gx, gy)
            sl = (gy[1] - gy[0]) / (gx[1] - gx[0] + 1e-10)
            sr_ = (gy[-1] - gy[-2]) / (gx[-1] - gx[-2] + 1e-10)
            vals = np.where(pos < gx[0], gy[0] + sl * (pos - gx[0]), vals)
            vals = np.where(pos > gx[-1], gy[-1] + sr_ * (pos - gx[-1]), vals)
            x[bad] = vals.astype(np.float32)
        elif good.size == 1:
            x[bad] = x[~bad][0]
        else:
            x = np.full_like(x, 300.0)
    if sigma_frames > 0:
        x = _np_gaussian1d(x, sigma_frames).astype(np.float32)
    return x


def _feature_path(in_file: Path) -> Path:
    return in_file.with_name(f"{in_file.stem}_features.goofy")


def acquire_features(in_file: Path, device: torch.device):
    """Load the source's cached ``.goofy`` (ref: SillySampler.py:415-432)
    and decode a knot-mode envelope on ``device``.  Returns (env, f0,
    voicing mask, formants, sr, y_len) as host arrays.

    A missing ``.goofy`` raises: feature extraction is not ported yet
    (``python -m goofer_tpu.cli <folder>`` writes the caches)."""
    feat = _feature_path(Path(in_file))
    if not feat.exists():
        raise FileNotFoundError(
            f"{feat} not found: goofer_tpu_torch renders from cached "
            f"features only (analysis is not ported yet)")
    log.info("Loading cached features")
    env, f0i, vmask, forms, sr, ylen = load_features(feat)
    if isinstance(env, dict) and env.get("mode") == "knots":
        knots = torch.as_tensor(
            np.asarray(env["knot_vals_log"], dtype=np.float32), device=device)
        env = decode_env_from_knots(knots, env["sr"], env["n_fft"],
                                    env["n_bins"]).cpu().numpy()
    return (np.asarray(env, dtype=np.float32), f0i, vmask, forms, sr, ylen)


def _unsupported_flags(p: NoteParams) -> list:
    return [name for name, on in (
        ("su", p.subharm_gain > 0.0),
        ("sj", p.growl_mix > 0.0),
        ("vf", p.fry_amount != 0.0),
        ("st", p.tension != 0.0)) if on]


class GooferResampler:
    """13-positional-arg UTAU resampler (ref: SillySampler.py:286-306).

    Constructing the object renders the note, like the reference.
    ``device`` None picks config.get_device() (CUDA unless
    $GOOFER_TPU_TORCH_DEVICE says otherwise); ``seed`` seeds every random
    stream of the render."""

    def __init__(self, in_file, out_file, pitch, velocity, flags="",
                 offset=0, length=1000, consonant=0, cutoff=0,
                 volume=100, modulation=0, tempo="!120", pitch_string="AA",
                 n_fft=config.SAMPLER_N_FFT, hop=config.SAMPLER_HOP,
                 seed: int = 0, device=None, autorender: bool = True):
        self.in_file = Path(in_file)
        self.out_file = Path(out_file)
        self.params = NoteParams.from_args(
            pitch, velocity, flags, offset, length, consonant, cutoff,
            volume, modulation, tempo, pitch_string)
        self.n_fft = n_fft
        self.hop = hop
        self.seed = seed
        self.device = config.get_device(device)
        if autorender:
            self.render()

    def render(self) -> None:
        p = self.params
        env, f0i, vmask, forms, sr, ylen = acquire_features(
            self.in_file, self.device)
        forms = formants_to_int_keys(forms)
        if p.reverse:
            log.info("Reversing features (R flag)")
            env = env[:, ::-1]
            f0i = f0i[::-1]
            vmask = vmask[::-1]
            forms = {k: np.asarray(forms[k])[::-1] for k in forms}
        out = self.resample(env, f0i, vmask, forms, sr, ylen)
        log.info("Writing %s", self.out_file)
        write_wav(self.out_file, out.cpu().numpy(), sr)

    def resample(self, env, f0i, vmask, forms, sr, ylen) -> torch.Tensor:
        """Host planning, then the note render on ``self.device``."""
        rs, arrays, scalars = self.prepare(env, f0i, vmask, forms, sr, ylen)
        log.info("Synthesizing")
        return render_note(rs, arrays, scalars, self.seed, self.device)

    def prepare(self, env, f0i, vmask, forms, sr, ylen):
        """Host planning: cut geometry, loop/velocity index plans, formant
        sanitize, pitch curve, pulse bounds.  Returns (RenderStatic,
        arrays, scalars) for render_core.render_note; the arrays are the
        ones goofer_tpu's prepare() builds for an exact-length plan."""
        p = self.params
        missing = _unsupported_flags(p)
        if missing:
            raise NotImplementedError(
                f"flag(s) {', '.join(missing)} not ported yet: "
                f"needs {SCAN_IIR_ITEM}")
        hop = self.hop
        sample_len_sec = ylen / sr

        cut = plan_cut(sample_len_sec, sr, hop, p.offset_sec,
                       p.consonant_sec, p.cutoff_sec, p.reverse)
        log.info("Interpolating features")
        env_cut = np.asarray(env[:, cut.start_frame:cut.end_frame],
                             dtype=np.float32)
        f0_cut = np.asarray(f0i[cut.start_sample:cut.end_sample],
                            dtype=np.float32)
        mask_cut = np.asarray(vmask[cut.start_sample:cut.end_sample],
                              dtype=np.float32)

        pre_frames = cut.consonant_frame - cut.start_frame
        tail_frames = cut.end_frame - cut.consonant_frame
        pre_samples = cut.consonant_sample - cut.start_sample
        tail_samples = cut.end_sample - cut.consonant_sample

        # --- SE editor + FV -------------------------------------------
        if p.use_editor:
            # the reference blocks on its tkinter editor here; the port
            # has no editor yet, so it renders unedited, as goofer_tpu
            # does headless
            log.warning("[SE] flag set but no editor is available "
                        "— rendering unedited")
        if p.force_voiced:
            mask_cut = np.ones_like(mask_cut)

        # --- sustain loop + velocity plans ----------------------------
        desired_tail_samples = int(p.length_sec * sr)
        desired_tail_frames = int(np.ceil(p.length_sec * sr / hop))

        env_plan = plan_env_loop(pre_frames, tail_frames,
                                 desired_tail_frames, p.loop_mode)
        target_frames = len(env_plan)
        # sample loop positions are rebuilt on the device from
        # (pre, tail) scalars (render_core.loop_positions)
        n_loop = pre_samples + desired_tail_samples

        vel = p.velocity_factor
        fplan = None
        vel_samp_on = False
        vel_pre_new = 1
        if abs(vel - 1.0) > 1e-6 and pre_frames > 1 and pre_samples > 1:
            fplan = plan_prefix_stretch(target_frames, pre_frames, vel)
            if n_loop > 1:
                vel_samp_on = True
                vel_pre_new = max(1, int(round(pre_samples * vel)))
        vel_on = fplan is not None or vel_samp_on
        t_env = len(fplan) if fplan is not None else target_frames
        n_total = (vel_pre_new + (n_loop - pre_samples) if vel_samp_on
                   else n_loop)

        # --- formant tracks: loop -> velocity -> canon -> sanitize ----
        track_plan = plan_track_loop(pre_frames, tail_frames,
                                     desired_tail_frames, p.loop_mode)
        rows = []
        rows_raw = []
        for k in (1, 2, 3, 4):
            track = np.asarray(forms.get(k, np.zeros(1)), dtype=np.float32)
            track = track[cut.start_frame:cut.end_frame]
            if track.size == 0:
                track = np.zeros(1, dtype=np.float32)
            looped = _np_fit(_np_apply_plan(track, track_plan),
                             target_frames)
            if fplan is not None:
                looped = _np_fit(_np_apply_plan(looped, fplan), t_env)
            # reference quirk: canon to the PRE-velocity frame count,
            # then sanitize edge-pads back out (ref: SillySampler.py:756,792)
            looped = _np_fit(looped, target_frames)
            # warp-anchor track: upstream's sanitize aliases the canon'd
            # track, so invalid frames reach the warp FILLED (unsmoothed)
            # unless velocity changed the frame count or no frame is
            # valid (ref: SillySampler.py:264-283 via 802-805, 1015)
            fit = _np_fit(looped, t_env)
            good_any = np.any(
                np.isfinite(fit) & (fit >= SANITIZE_MIN_HZ[k - 1])
                & (fit <= sr * 0.48))
            if t_env == target_frames and good_any:
                warp_tr = sanitize_formant_track(
                    looped, t_env, sr, SANITIZE_MIN_HZ[k - 1],
                    sigma_frames=0)
            else:
                warp_tr = fit
            rows_raw.append(warp_tr)
            rows.append(sanitize_formant_track(
                looped, t_env, sr, SANITIZE_MIN_HZ[k - 1], sigma_frames=4))
        tracks, tracks_raw = np.stack(rows), np.stack(rows_raw)

        # --- pitch curve ------------------------------------------------
        # the device interpolates the tick-rate curve per sample; the
        # host's dense curve only feeds the pd scale and pulse bounds
        tick_dt = 60.0 / (p.tempo * 96.0)
        semi = p.bend_cents.astype(np.float64) / 100.0 + p.pitch_midi
        if p.t_cents:
            semi = semi + p.t_cents / 100.0
        n_ticks = len(semi)
        pitch_ticks = np.full(max(16, 1 << (n_ticks - 1).bit_length()),
                              semi[-1], dtype=np.float32)
        pitch_ticks[:n_ticks] = semi.astype(np.float32)

        semi = pitch_ticks[:n_ticks].astype(np.float64)
        if n_ticks == 1:
            midi_curve = np.full(n_total, float(semi[0]))
        else:
            t_max = (n_ticks - 1) * tick_dt
            t_clamped = np.clip(np.arange(n_total) / sr, 0.0, t_max)
            midi_curve = np.interp(t_clamped / tick_dt,
                                   np.arange(n_ticks), semi)

        # --- pd: 95th-percentile scale of the smoothed bend (host) -----
        pd_baseline = p.pitch_midi + (p.t_cents / 100.0)
        pd_ref = 1.0
        if p.pitch_dyn != 0.0:
            bend = _np_gaussian1d(midi_curve - pd_baseline,
                                  float(max(1, int(0.010 * sr))))
            pd_ref = float(np.percentile(np.abs(bend), 95.0) + 1e-8)

        # --- pulse bounds from the f0 range this note can produce -------
        # longest pulse ~ sr/f0_floor samples, onsets up to f0_ceil/sr per
        # sample, pulses are zero past u = Ra + Rk*(1-Ra) ~= 0.804
        hz_lo = float(440.0 * 2.0 ** ((np.min(midi_curve) - 69.0) / 12.0))
        hz_hi = float(440.0 * 2.0 ** ((np.max(midi_curve) - 69.0) / 12.0))
        jit_lo = max(0.25, 1.0 - p.f0_jitter_strength) if p.f0_jitter else 1.0
        jit_hi = (1.0 + p.f0_jitter_strength) if p.f0_jitter else 1.0
        f0_floor = max(1.0, min(hz_lo, config.PULSE_FALLBACK_F0) * jit_lo)
        f0_ceil = max(hz_hi, config.PULSE_FALLBACK_F0) * jit_hi
        max_overlap = config.bucket_overlap(int(min(32, max(
            3, math.ceil(0.804 * f0_ceil / f0_floor) + 2))))
        min_spacing = config.bucket_min_spacing(int(sr / max(f0_ceil, 1.0)))
        # subharmonic layer: semitones=12 (2x) under a depth-3 vibrato
        # (peak f0 x (1 + depth)), hardcoded at the main synth call
        subharm_min_spacing = config.bucket_min_spacing(int(sr / max(
            f0_ceil * 2.0 * 4.0, 1.0)))

        rs = RenderStatic(
            sr=sr, n_fft=self.n_fft, hop=hop, n=n_total, t_env=t_env,
            tilt_on=p.brightness_env != 1.0,
            shape_amt=float(p.env_shape),
            fw_on=p.formant_width != 0.0,
            vel_on=vel_on,
            strengths_on=any(abs(s) > 1e-6 for s in p.formant_strengths),
            pd_on=p.pitch_dyn != 0.0,
            f0_jitter=p.f0_jitter,
            volume_jitter=p.volume_jitter,
            add_subharm=p.add_subharm,
            warp_formants=any(s != 1.0 for s in p.f_shifts),
            formant_shift_on=p.formant_shift != 1.0,
            sd_on=p.sd_strength > 0,
            sa_on=p.aperiodic_mix > 0.0,
            max_overlap=max_overlap,
            min_spacing=min_spacing,
            subharm_min_spacing=subharm_min_spacing,
            n_loop=n_loop,
        )

        one = np.zeros(1, dtype=np.float32)
        arrays = {
            "env_cut": env_cut,
            "f0_cut": f0_cut if f0_cut.size else one,
            "mask_cut": mask_cut if mask_cut.size else one,
            "env_pos0": env_plan.pos0, "env_pos1": env_plan.pos1,
            "env_w": env_plan.w,
            "vel_env_pos": (fplan.pos0 if fplan is not None else one),
            "tracks": tracks,
            "tracks_raw": tracks_raw,
            "pitch_ticks": pitch_ticks,
        }
        scalars = {
            "brightness_env": p.brightness_env,
            "fw_amount": p.formant_width,
            "formant_shift": p.formant_shift,
            "formant_band_shifts": np.asarray(p.f_shifts, dtype=np.float32),
            "formant_strengths": np.asarray(p.formant_strengths,
                                            dtype=np.float32),
            "f0_jitter_strength": p.f0_jitter_strength,
            "volume_jitter_strength": p.volume_jitter_strength,
            "subharm_weight": p.subharm_weight,
            "normalize": p.normalize,
            "pitch_dyn": p.pitch_dyn,
            "pd_baseline": pd_baseline,
            "pd_ref": pd_ref,
            "tick_dt_samp": tick_dt * sr,
            "n_ticks": float(n_ticks),
            "sd_strength": p.sd_strength,
            "harmonic_mix": p.harmonic_mix,
            "breathiness_mix": p.breathiness_mix,
            "unvoiced_mix": p.unvoiced_mix,
            "volume": p.volume,
            "aperiodic_mix": p.aperiodic_mix,
            "uv_strength": 0.75,
            "breath_strength": 0.1,
            "loop_pre": float(pre_samples),
            "loop_tail": float(max(1, tail_samples)),
            "vel_pre_new": float(vel_pre_new if vel_samp_on else 1),
            "vel_pre_len": float(pre_samples if vel_samp_on else 1),
            "vel_factor": float(vel if vel_samp_on else 1.0),
        }
        return rs, arrays, scalars
