"""Note renderer: the UTAU resample pipeline.

Port of goofer_tpu/sampler/resampler.py (``GooferResampler``,
ref: SillySampler.py:415-1185).  The host computes index plans, formant
sanitization, the pitch curve and the pulse bounds (small NumPy work, the
same code as goofer_tpu); the render itself (sampler/render_core.py)
runs as PyTorch on the chosen device.

Features come from the source's ``.goofy`` cache, which the first render
of a source extracts and saves (analysis/features.py); every flag of the
13-argument CLI renders, and ``SE1`` runs the voicing editor's hook on
the note's snippet and writes the edit back into the ``.goofy``.
"""
from __future__ import annotations

import logging
import math
import threading
from dataclasses import replace
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
from goofer_tpu_torch.sampler.render_core import RenderStatic, render_note
from goofer_tpu_torch.utils.audio_io import write_wav
from goofer_tpu_torch.utils.profiling import (
    StageTimer,
    count,
    device_trace,
    entry,
    phases,
    profiling_enabled,
    snapshot,
    span,
    span_report,
    spans_enabled,
    traced,
)

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


def midi_curve_range(ticks: np.ndarray, tick_dt: float, sr: int,
                     n: int) -> tuple:
    """The least and the greatest sample of the pitch curve: ``ticks``
    (MIDI, one per ``tick_dt`` seconds) interpolated at the ``n`` sample
    times, held at the last tick past it.

    The sampled curve is linear between two ticks, and its rounded
    values are monotone there, so its extremes lie at the samples on
    either side of a tick.  np.interp runs on those samples alone, with
    the same arithmetic as over all ``n``: the same bits as the dense
    curve's min and max."""
    semi = np.asarray(ticks, np.float64)
    k = len(semi)
    if k == 1:
        return float(semi[0]), float(semi[0])
    t_max = (k - 1) * tick_dt
    # the first sample at or past each tick, give or take one
    edge = np.ceil(np.arange(1, k) * (tick_dt * sr)).astype(np.int64)
    j = np.unique(np.clip(np.concatenate(
        [[0, n - 1], edge - 2, edge - 1, edge, edge + 1]), 0, n - 1))
    t_clamped = np.clip(j / sr, 0.0, t_max)
    curve = np.interp(t_clamped / tick_dt, np.arange(k), semi)
    return float(np.min(curve)), float(np.max(curve))


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


def _pad_memo(memo: dict, arr: np.ndarray, target: int, mode: str,
              axis: int = -1) -> np.ndarray:
    """Pad ``arr`` to ``target`` along ``axis``, memoized on the source
    object's identity so arrays shared across notes pad to a SHARED
    padded object (the phrase renderer sends such an array to the device
    once)."""
    cur = arr.shape[axis]
    if cur >= target:
        return arr
    key = ("pad", id(arr), target, mode, axis)
    out = memo.get(key)
    if out is None:
        width = [(0, 0)] * arr.ndim
        width[axis] = (0, target - cur)
        if mode == "zero":
            out = np.pad(arr, width)
        else:
            out = np.pad(arr, width, mode="edge")
        memo[key] = out
    return out


def _bucketize(rs: RenderStatic, arrays: dict, memo: dict):
    """Pad note geometry to shared length buckets, so that notes of
    nearby lengths form one batch.

    Sample counts round up to a ~1.5-ratio geometric bucket
    (config.bucket_len); frame counts derive from the sample bucket so a
    bucket pair never splits a group.  Plan/position arrays pad by
    repeating their last entry (the padded tail replays the final true
    frame/sample), features pad edge.  The render (RenderStatic.masked)
    zeroes everything past the scalar ``n_true`` before any
    normalization, so padded output matches the exact render over the
    true region up to the boundary smoothing of the voiced/unvoiced
    crossfade.  The phrase renderer slices results back to n_true."""
    hop = rs.hop
    # n_fft//2 headroom: the masked synth writes the true-end stft reflect
    # pad into the padded region past n_true
    n_b = config.bucket_len(rs.n + rs.n_fft // 2)
    te_b = config.bucket_frames(n_b, hop)
    if rs.t_env > te_b:                       # pathological geometry
        te_b = config.bucket_frames(config.bucket_len(rs.t_env * hop), hop)

    def fbucket(frames: int) -> int:
        return config.bucket_frames(config.bucket_len(frames * hop), hop)

    a = dict(arrays)
    a["env_cut"] = _pad_memo(memo, a["env_cut"],
                             fbucket(a["env_cut"].shape[1]), "edge", axis=1)
    s_b = config.bucket_len(max(a["f0_cut"].shape[0],
                                a["mask_cut"].shape[0]))
    a["f0_cut"] = _pad_memo(memo, a["f0_cut"], s_b, "edge")
    a["mask_cut"] = _pad_memo(memo, a["mask_cut"], s_b, "edge")

    # env plan: post-velocity env frames must land on te_b; with velocity
    # the plan lives in the pre-warp domain and buckets independently.
    # Sample-domain loop/velocity positions are closed forms built on the
    # device, so only the pre-velocity length (rs.n_loop) buckets.
    ep_b = fbucket(len(a["env_pos0"])) if rs.vel_on else te_b
    for k in ("env_pos0", "env_pos1", "env_w"):
        a[k] = _pad_memo(memo, a[k], ep_b, "edge")
    if rs.vel_on:
        a["vel_env_pos"] = _pad_memo(memo, a["vel_env_pos"], te_b, "edge")
        n_loop_b = config.bucket_len(rs.n_loop or rs.n)
    else:
        n_loop_b = n_b

    a["tracks"] = _pad_memo(memo, a["tracks"], te_b, "edge", axis=1)
    a["tracks_raw"] = _pad_memo(memo, a["tracks_raw"], te_b, "edge", axis=1)

    return replace(rs, n=n_b, t_env=te_b, n_loop=n_loop_b, masked=True), a


def _feature_path(in_file: Path) -> Path:
    return in_file.with_name(f"{in_file.stem}_features.goofy")


def _src_tag(feat_path: str) -> str:
    stem = Path(feat_path).name
    if stem.endswith("_features.goofy"):
        return stem[: -len("_features.goofy")]
    return Path(feat_path).stem


def invalidate_render_cache(out_path: str, feat_path: str) -> None:
    """Delete cached renders for a source after a voicing edit
    (ref: SillySampler.py:23-41)."""
    try:
        out_dir = Path(out_path).parent
        tag = _src_tag(feat_path)
        for p in out_dir.glob(f"{tag}*.wav"):
            try:
                p.unlink()
                log.info("[SE] Invalidated cache: %s", p.name)
            except Exception as e:  # pragma: no cover
                log.warning("[SE] Could not delete %s: %s", p, e)
        for ext in ("json", "txt", "lock"):
            for p in out_dir.glob(f"{tag}*.{ext}"):
                try:
                    p.unlink()
                except Exception:  # pragma: no cover
                    pass
    except Exception as e:  # pragma: no cover
        log.warning("[SE] Cache invalidate failed: %s", e)


# get/insert under a lock: phrase plans may run on several threads, and
# readers hold their own reference, so the clear-when-full sweep cannot
# take an entry away mid-use
_decoded_lock = threading.Lock()
_decoded_cache: dict = {}
# one lock per fresh source (taken under _decoded_lock): concurrent
# requests for a source without a cache extract it once, and the rest
# load the cache that extraction wrote
_extract_locks: dict = {}


def _extract_and_save(in_file: Path, feat: Path, n_fft: int, hop: int,
                      device: torch.device):
    from goofer_tpu_torch.analysis.features import extract_features
    from goofer_tpu_torch.io.goofy import save_features_atomic
    from goofer_tpu_torch.utils.audio_io import read_wav_mono

    log.info("Extracting features")
    y, sr = read_wav_mono(in_file)
    env, f0i, vmask, forms, knots = extract_features(
        y, sr, n_fft=n_fft, hop_length=hop, device=device)
    save_features_atomic(feat, knots, f0i, vmask, forms, sr, len(y))
    return np.asarray(env, dtype=np.float32), f0i, vmask, forms, sr, len(y)


@traced("features.acquire")
def acquire_features(in_file: Path, n_fft: int, hop: int,
                     device: torch.device):
    """Load the source's cached ``.goofy`` or extract and save it
    (ref: SillySampler.py:415-432); a knot-mode envelope is decoded, and a
    missing cache extracted, on ``device``.  Returns (env, f0, voicing
    mask, formants, sr, y_len) as host arrays.

    Decoded features are memoized on (path, mtime, n_fft, hop): repeated
    phrase plans against one source skip the parse and the decode and get
    the SAME tuple, which the phrase planner's memo keys on.

    Thread-safe: of concurrent requests for one source without a cache,
    one extracts it and writes the ``.goofy`` atomically while the others
    wait, then load it.

    Counters ``features.memo.hit`` / ``.miss`` (an extraction, or a load
    and decode) / ``.clear``; spans ``features.extract``, ``.load`` and
    ``.decode``."""
    in_file = Path(in_file)
    feat = _feature_path(in_file)
    if not feat.exists():
        with _decoded_lock:
            lock = _extract_locks.setdefault(str(feat), threading.Lock())
        with lock:
            if not feat.exists():
                count("features.memo.miss")
                with span("features.extract"):
                    return _extract_and_save(in_file, feat, n_fft, hop,
                                             device)
    ck = (str(feat), feat.stat().st_mtime_ns, n_fft, hop)
    with _decoded_lock:
        hit = _decoded_cache.get(ck)
        count("features.memo.miss" if hit is None else "features.memo.hit")
    if hit is not None:
        return hit
    log.info("Loading cached features")
    with span("features.load"):
        env, f0i, vmask, forms, sr, ylen = load_features(feat)
    if isinstance(env, dict) and env.get("mode") == "knots":
        with span("features.decode"):
            knots = torch.as_tensor(
                np.asarray(env["knot_vals_log"], dtype=np.float32),
                device=device)
            env = decode_env_from_knots(knots, env["sr"], env["n_fft"],
                                        env["n_bins"]).cpu().numpy()
    out = (np.asarray(env, dtype=np.float32), f0i, vmask, forms, sr, ylen)
    with _decoded_lock:
        if len(_decoded_cache) > 64:
            _decoded_cache.clear()
            count("features.memo.clear")
        _decoded_cache[ck] = out
    return out


def forget_features(feat: Path) -> None:
    """Drop a ``.goofy``'s memoized decodes after it was rewritten: a
    rewrite within one mtime tick of a coarse filesystem would otherwise
    serve the old voicing to the next note."""
    with _decoded_lock:
        for ck in [k for k in _decoded_cache if k[0] == str(feat)]:
            del _decoded_cache[ck]


class GooferResampler:
    """13-positional-arg UTAU resampler (ref: SillySampler.py:286-306).

    Constructing the object renders the note, like the reference.
    ``editor_hook(y_snip, sr, init_mask) -> mask|None`` replaces the
    blocking tkinter editor for SE1.  ``device`` None picks
    config.get_device() (CUDA unless $GOOFER_TPU_TORCH_DEVICE says
    otherwise); ``seed`` seeds every random stream of the render."""

    def __init__(self, in_file, out_file, pitch, velocity, flags="",
                 offset=0, length=1000, consonant=0, cutoff=0,
                 volume=100, modulation=0, tempo="!120", pitch_string="AA",
                 editor_hook=None, n_fft=config.SAMPLER_N_FFT,
                 hop=config.SAMPLER_HOP, seed: int = 0, device=None,
                 autorender: bool = True):
        self.in_file = Path(in_file)
        self.out_file = Path(out_file)
        with span("plan.flags"):
            self.params = NoteParams.from_args(
                pitch, velocity, flags, offset, length, consonant, cutoff,
                volume, modulation, tempo, pitch_string)
        self.editor_hook = editor_hook
        self.n_fft = n_fft
        self.hop = hop
        self.seed = seed
        self.device = config.get_device(device)
        if autorender:
            self.render()

    @entry()
    def render(self) -> None:
        """Render the note and write its WAV, one ``request``.
        $GOOFER_TPU_PROFILE logs the features / resample / write split and
        then the span totals, $GOOFER_TPU_TRACE_DIR writes a trace of the
        render (utils/profiling.py).  With spans on, the host's wait for
        the card is its own span (``render.wait``), ahead of the copy."""
        p = self.params
        timer = StageTimer(enabled=profiling_enabled(), device=self.device)
        before = snapshot(records=False) if timer.enabled else None
        with device_trace(device=self.device):
            with timer.stage("features"):
                env, f0i, vmask, forms, sr, ylen = acquire_features(
                    self.in_file, self.n_fft, self.hop, self.device)
                with span("plan.features"):
                    forms = formants_to_int_keys(forms)
                    if p.reverse:
                        log.info("Reversing features (R flag)")
                        env = env[:, ::-1]
                        f0i = f0i[::-1]
                        vmask = vmask[::-1]
                        forms = {k: np.asarray(forms[k])[::-1]
                                 for k in forms}

            with timer.stage("resample"):
                out = self.resample(env, f0i, vmask, forms, sr, ylen)
                if spans_enabled() and out.device.type == "cuda":
                    with span("render.wait"):
                        torch.cuda.current_stream(out.device).synchronize()
                with span("render.fetch"):
                    out = out.cpu().numpy()

            with timer.stage("write"):
                log.info("Writing %s", self.out_file)
                write_wav(self.out_file, out, sr)
        if timer.enabled:
            timer.report(audio_seconds=len(out) / sr)
            log.info("%s", span_report(snapshot(records=False).since(before)))

    def _editor_roundtrip(self, mask_cut: np.ndarray, cut, sr):
        """SE1: run the voicing editor on the note snippet and write the
        edited mask back into the .goofy (ref: SillySampler.py:577-616)."""
        from goofer_tpu_torch.editor.core import write_back_voicing
        from goofer_tpu_torch.utils.audio_io import read_wav_mono

        p = self.params
        feat_path = _feature_path(self.in_file)
        y_src, _ = read_wav_mono(self.in_file)
        if p.reverse:
            y_src = y_src[::-1]
        y_snip = y_src[cut.start_sample:cut.end_sample].astype(np.float32)

        result = self.editor_hook(y_snip, sr, mask_cut.astype(np.float32))
        if result is not None and len(result) == len(mask_cut):
            edited = np.asarray(result, dtype=np.float32)
            write_back_voicing(str(feat_path), edited, cut.start_sample,
                               cut.end_sample, p.reverse)
            forget_features(feat_path)
            invalidate_render_cache(str(self.out_file), str(feat_path))
            return edited
        return mask_cut

    def resample(self, env, f0i, vmask, forms, sr, ylen) -> torch.Tensor:
        """Host planning, then the note render on ``self.device``."""
        count("plan.notes")
        rs, arrays, scalars = self.prepare(env, f0i, vmask, forms, sr, ylen)
        log.info("Synthesizing")
        return render_note(rs, arrays, scalars, self.seed, self.device)

    @traced("plan.prepare")
    def prepare(self, env, f0i, vmask, forms, sr, ylen, cache=None):
        """Host planning: cut geometry, loop/velocity index plans, formant
        sanitize, pitch curve, pulse bounds.  Returns (RenderStatic,
        arrays, scalars) for render_core.render_note; the arrays are the
        ones goofer_tpu's prepare() builds for an exact-length plan.

        ``cache`` (optional dict, shared across the notes of a phrase)
        memoizes cut slices, looped formant tracks and pitch curves, so
        that repeated notes contribute identical array OBJECTS, which
        the phrase renderer then sends to the device once."""
        p = self.params
        hop = self.hop
        sample_len_sec = ylen / sr
        memo = cache if cache is not None else {}

        def cached(key, fn):
            val = memo.get(key)
            if val is None:
                val = fn()
                memo[key] = val
            return val

        ph = phases()
        ph.mark("plan.cut")
        cut = plan_cut(sample_len_sec, sr, hop, p.offset_sec,
                       p.consonant_sec, p.cutoff_sec, p.reverse)
        log.info("Interpolating features")
        env_cut = cached(
            ("env_cut", id(env), cut.start_frame, cut.end_frame),
            lambda: np.asarray(env[:, cut.start_frame:cut.end_frame],
                               dtype=np.float32))
        f0_cut = cached(
            ("f0_cut", id(f0i), cut.start_sample, cut.end_sample),
            lambda: np.asarray(f0i[cut.start_sample:cut.end_sample],
                               dtype=np.float32))
        mask_cut = cached(
            ("mask_cut", id(vmask), cut.start_sample, cut.end_sample),
            lambda: np.asarray(vmask[cut.start_sample:cut.end_sample],
                               dtype=np.float32))

        pre_frames = cut.consonant_frame - cut.start_frame
        tail_frames = cut.end_frame - cut.consonant_frame
        pre_samples = cut.consonant_sample - cut.start_sample
        tail_samples = cut.end_sample - cut.consonant_sample

        # --- SE editor + FV -------------------------------------------
        if p.use_editor:
            if self.editor_hook is not None:
                mask_cut = self._editor_roundtrip(mask_cut, cut, sr)
            else:
                # the reference blocks on its tkinter editor here;
                # headless, the skip is logged, never silent
                log.warning("[SE] flag set but no editor is available "
                            "(no display/tkinter) — rendering unedited")
        if p.force_voiced:
            mask_cut = np.ones_like(mask_cut)

        ph.mark("plan.loop")
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

        ph.mark("plan.tracks")
        # --- formant tracks: loop -> velocity -> canon -> sanitize ----
        track_plan = plan_track_loop(pre_frames, tail_frames,
                                     desired_tail_frames, p.loop_mode)

        def build_tracks():
            rows = []
            rows_raw = []
            for k in (1, 2, 3, 4):
                track = np.asarray(forms.get(k, np.zeros(1)),
                                   dtype=np.float32)
                track = track[cut.start_frame:cut.end_frame]
                if track.size == 0:
                    track = np.zeros(1, dtype=np.float32)
                looped = _np_fit(_np_apply_plan(track, track_plan),
                                 target_frames)
                if fplan is not None:
                    looped = _np_fit(_np_apply_plan(looped, fplan), t_env)
                # reference quirk: canon to the PRE-velocity frame count,
                # then sanitize edge-pads back out
                # (ref: SillySampler.py:756,792)
                looped = _np_fit(looped, target_frames)
                # warp-anchor track: upstream's sanitize aliases the
                # canon'd track, so invalid frames reach the warp FILLED
                # (unsmoothed) unless velocity changed the frame count or
                # no frame is valid (ref: SillySampler.py:264-283 via
                # 802-805, 1015)
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
                    looped, t_env, sr, SANITIZE_MIN_HZ[k - 1],
                    sigma_frames=4))
            return np.stack(rows), np.stack(rows_raw)

        tracks, tracks_raw = cached(
            ("tracks", id(forms), cut.start_frame, cut.end_frame,
             p.loop_mode, desired_tail_frames, target_frames, t_env, vel),
            build_tracks)

        ph.mark("plan.pitch")
        # --- pitch curve ------------------------------------------------
        # the device interpolates the tick-rate curve per sample; the host
        # needs only the sampled curve's extremes, for the pulse bounds
        tick_dt = 60.0 / (p.tempo * 96.0)

        def build_ticks():
            semi = p.bend_cents.astype(np.float64) / 100.0 + p.pitch_midi
            if p.t_cents:
                semi = semi + p.t_cents / 100.0
            k = len(semi)
            out = np.full(max(16, 1 << (k - 1).bit_length()), semi[-1],
                          dtype=np.float32)
            out[:k] = semi.astype(np.float32)
            return out, k

        pitch_ticks, n_ticks = cached(
            ("ticks", p.pitch_midi, p.t_cents, p.bend_cents.tobytes()),
            build_ticks)

        midi_lo, midi_hi = cached(
            ("midi", n_total, p.pitch_midi, p.t_cents, p.tempo,
             p.bend_cents.tobytes()),
            lambda: midi_curve_range(pitch_ticks[:n_ticks], tick_dt, sr,
                                     n_total))
        # pd: the bend is measured from this baseline; its 95th-percentile
        # scale is render_core.pd_scale's, on the device
        pd_baseline = p.pitch_midi + (p.t_cents / 100.0)

        ph.mark("plan.scalars")
        # --- fry weights and tension ------------------------------------
        vf = min(100.0, max(-100.0, float(p.fry_amount)))
        fry_on = vf != 0.0
        fry_sc = _fry_scalars(n_total, sr, vf, p.fry_glide_pct)
        tension_sign = 0 if p.tension == 0 else (1 if p.tension > 0 else -1)
        tension_order = int(min(6, max(1, round(1 + abs(p.tension) * 4))))

        # --- pulse bounds from the f0 range this note can produce -------
        # longest pulse ~ sr/f0_floor samples, onsets up to f0_ceil/sr per
        # sample, pulses are zero past u = Ra + Rk*(1-Ra) ~= 0.804
        hz_lo = float(440.0 * 2.0 ** ((midi_lo - 69.0) / 12.0))
        hz_hi = float(440.0 * 2.0 ** ((midi_hi - 69.0) / 12.0))
        floor_cands = [hz_lo, config.PULSE_FALLBACK_F0]
        ceil_cands = [hz_hi, config.PULSE_FALLBACK_F0]
        if fry_on:
            floor_cands.append(p.fry_base_hz)
            ceil_cands.append(p.fry_base_hz)
        jit_lo = max(0.25, 1.0 - p.f0_jitter_strength) if p.f0_jitter else 1.0
        jit_hi = (1.0 + p.f0_jitter_strength) if p.f0_jitter else 1.0
        f0_floor = max(1.0, min(floor_cands) * jit_lo)
        f0_ceil = max(ceil_cands) * jit_hi
        ratio = f0_ceil / f0_floor
        max_overlap = config.bucket_overlap(int(min(32, max(
            3, math.ceil(0.804 * ratio) + 2))))
        # growl layer: f0 * 0.5 * 2**N(0, mix^2); its spread is bounded at
        # 3 sigma each way (tails only lose low-amplitude pulse ends)
        spread = 2.0 ** (6.0 * p.growl_mix ** 2) if p.growl_mix > 0 else 1.0
        growl_max_overlap = config.bucket_overlap(int(min(32, max(
            3, math.ceil(0.804 * ratio * spread) + 2))))
        min_spacing = config.bucket_min_spacing(int(sr / max(f0_ceil, 1.0)))
        growl_min_spacing = config.bucket_min_spacing(int(sr / max(
            f0_ceil * 0.5 * spread, 1.0)))
        # su layer: f0/2, so onsets are twice as sparse
        su_min_spacing = config.bucket_min_spacing(int(sr / max(
            f0_ceil * 0.5, 1.0)))
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
            fry_on=fry_on,
            f0_jitter=p.f0_jitter,
            volume_jitter=p.volume_jitter,
            add_subharm=p.add_subharm,
            warp_formants=any(s != 1.0 for s in p.f_shifts),
            formant_shift_on=p.formant_shift != 1.0,
            su_on=p.subharm_gain > 0.0,
            sj_on=p.growl_mix > 0.0,
            sd_on=p.sd_strength > 0,
            tension_sign=tension_sign,
            tension_order=tension_order,
            sa_on=p.aperiodic_mix > 0.0,
            max_overlap=max_overlap,
            growl_max_overlap=growl_max_overlap,
            min_spacing=min_spacing,
            growl_min_spacing=growl_min_spacing,
            subharm_min_spacing=subharm_min_spacing,
            su_min_spacing=su_min_spacing,
            n_loop=n_loop,
        )

        one = cached(("zeros1",), lambda: np.zeros(1, dtype=np.float32))
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
            "tick_dt_samp": tick_dt * sr,
            "n_ticks": float(n_ticks),
            "fry_vh": p.fry_base_hz,
            "subharm_gain": p.subharm_gain,
            "growl_mix": p.growl_mix,
            "sd_strength": p.sd_strength,
            "tension": p.tension,
            "harmonic_mix": p.harmonic_mix,
            "breathiness_mix": p.breathiness_mix,
            "unvoiced_mix": p.unvoiced_mix,
            "volume": p.volume,
            "aperiodic_mix": p.aperiodic_mix,
            "n_true": float(n_total),
            "uv_strength": 0.75,
            "breath_strength": 0.1,
            "loop_pre": float(pre_samples),
            "loop_tail": float(max(1, tail_samples)),
            "vel_pre_new": float(vel_pre_new if vel_samp_on else 1),
            "vel_pre_len": float(pre_samples if vel_samp_on else 1),
            "vel_factor": float(vel if vel_samp_on else 1.0),
            **fry_sc,
        }
        ph.end()
        return rs, arrays, scalars


def _fry_scalars(n: int, sr: int, vf: float, vl: float) -> dict:
    """Exact integer region bounds and ramp slopes of the fry weight and
    mask curves (ref: SillySampler.py:883-965), for
    render_core.fry_curves; all zero when ``vf`` is 0.

    base_w: 1 on [c0, c1), r0 + rs*(j - g0) on [g0, g1), else 0.
    fry_mask: on [s, e): ramp-in (j - s)*rin for j < a1 (else 1) times
    ramp-out 1 - (j - b0)*rout for j >= b0 (else 1)."""
    c0 = c1 = g0 = g1 = 0
    r0 = rs_ = 0.0
    if vf > 0:
        L = int(round(n * (vf / 100.0)))
        if L > 0:
            glide = min(L, max(0, int(round(L * (vl / 100.0)))))
            const = L - glide
            c0, c1 = 0, const
            if glide > 0:
                # base_w = 1 - linspace(0, 1, glide)
                g0, g1 = const, L
                r0 = 1.0
                rs_ = -1.0 / (glide - 1) if glide > 1 else 0.0
    elif vf < 0:
        L = int(round(n * (abs(vf) / 100.0)))
        if L > 0:
            glide = min(L, max(0, int(round(L * (vl / 100.0)))))
            const = L - glide
            start = n - L
            if glide > 0:
                # base_w = 1 - linspace(1, 0, glide)
                g0, g1 = start, start + glide
                r0 = 0.0
                rs_ = 1.0 / (glide - 1) if glide > 1 else 0.0
            if const > 0:
                c0, c1 = start + glide, n

    # faded region mask, sized from the note midpoint
    # (ref: SillySampler.py:937-965)
    s_i = e_i = a1 = b0 = 0
    rin = rout = 0.0
    if vf != 0:
        mid = n // 2
        if vf > 0:
            L2 = int(round(mid * (vf / 100.0)))
            s_i, e_i = 0, max(0, min(n, L2))
        else:
            L2 = int(round((n - mid) * (abs(vf) / 100.0)))
            s_i, e_i = max(0, n - L2), n
        a1, b0 = s_i, e_i
        if e_i > s_i:
            fade = int(0.01 * sr)
            if fade > 0:
                a1 = min(e_i, s_i + fade)
                if a1 - s_i > 1:
                    rin = 1.0 / (a1 - s_i - 1)
                b0 = max(s_i, e_i - fade)
                if e_i - b0 > 1:
                    rout = 1.0 / (e_i - b0 - 1)
        else:
            s_i = e_i = 0
    return {
        "fry_c0": float(c0), "fry_c1": float(c1),
        "fry_g0": float(g0), "fry_g1": float(g1),
        "fry_r0": float(r0), "fry_rs": float(rs_),
        "fry_s": float(s_i), "fry_e": float(e_i),
        "fry_a1": float(a1), "fry_rin": float(rin),
        "fry_b0": float(b0), "fry_rout": float(rout),
    }
