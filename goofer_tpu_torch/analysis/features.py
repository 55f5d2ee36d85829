"""Feature extraction: spectral envelope + F0 + voicing + formants + knots.

Port of goofer_tpu/analysis/features.py, mirroring the reference analysis
entry (ref: GOOFER.py:940-969):

* envelope = Gaussian-blurred STFT magnitude (sigma = 2 freq bins);
* F0 = AC pitch track -> nan->0 -> short-gap bridging -> linear per-sample
  interpolation over a shared [0, duration] axis -> clip [1e-5, 2000];
* voicing mask = f0_interp > 75 Hz;
* formants = Burg tracks padded to the envelope frame count;
* mel-knot compression of the envelope for storage.

Files ride one leading batch axis.  ``extract_features_batch`` groups
them by padded length (config.bucket_len, so that padding waste is
bounded), pads each group's waveforms with zeros and runs the whole
analysis of a chunk of files as one batched pass (``analyze_chunk``):
each row carries its true sample count and the pitch and formant frame
grids of its true length, so a padded row's features equal the file's
alone.  ``extract_features`` is a batch of one.  goofer_tpu's cached
graphs, output packing and dispatch window bound XLA compiles and
device-to-host transfers on its platform and are not ported.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from goofer_tpu_torch import config
from goofer_tpu_torch.analysis.formants import formant_frame_grid, formant_graph
from goofer_tpu_torch.analysis.pitch import (
    PitchConfig,
    _frame_grid,
    fix_f0_gaps,
    padded_grid,
    pitch_graph,
    pitch_window_len,
)
from goofer_tpu_torch.devices import run_on_slots, shard_bounds
from goofer_tpu_torch.ops.envelope import (
    KNOT_EPS,
    KNOT_K_VALUES,
    _knot_bin_idx,
    knot_errors,
    mel_knot_freqs,
)
from goofer_tpu_torch.ops.filters import gaussian_blur1d
from goofer_tpu_torch.ops.interp import gather_lerp
from goofer_tpu_torch.ops.stft import stft

# Files per chunk, and frames per chunk (files x padded frame count).  The
# pitch pass holds, per frame, the nfft-padded window, its spectrum and
# its autocorrelation: 48 KB at nfft 4096 (44.1 kHz, 75 Hz floor), so
# 16384 frames keep a chunk's pitch pass under 1 GB of device memory.  A
# single file longer than that still runs, alone.
EXTRACT_CHUNK_FILES = 64
EXTRACT_CHUNK_FRAMES = 16384


def _pick_knots(log_env: torch.Tensor, errs: torch.Tensor, sr: int,
                n_fft: int):
    """The adaptive-K search on the device (ref: GOOFER.py:97-147): per
    row of (B, n_bins, T) ``log_env`` the first K whose error is under
    KNOT_EPS (fallback: K_max), and its knot rows as float16, padded to
    K_max rows by repeating the last.  Returns (knots16 (B, K_max, T),
    index into KNOT_K_VALUES (B,))."""
    n_bins = log_env.shape[-2]
    ok = errs < KNOT_EPS
    chosen = torch.where(ok.any(dim=1), ok.int().argmax(dim=1),
                         len(KNOT_K_VALUES) - 1)
    k_top = max(KNOT_K_VALUES)
    idx_stack = np.stack([
        np.pad(_knot_bin_idx(sr, n_fft, k, n_bins), (0, k_top - k),
               mode="edge")
        for k in KNOT_K_VALUES])
    rows = torch.as_tensor(idx_stack, device=log_env.device)[chosen]
    rows = rows[:, :, None].expand(-1, -1, log_env.shape[-1])
    return torch.gather(log_env, 1, rows).to(torch.float16), chosen


def _knot_pack(knots16: np.ndarray, chosen_idx: int, sr: int, n_fft: int,
               t_true: int) -> dict:
    """The ``.goofy`` knot dict of one row of _pick_knots' output."""
    k = int(KNOT_K_VALUES[int(chosen_idx)])
    return {
        "mode": "knots",
        "knot_vals_log": np.ascontiguousarray(knots16[:k, :t_true]),
        "hz_knots": mel_knot_freqs(sr, n_fft, k),
        "n_bins": int(n_fft // 2 + 1),
        "n_fft": int(n_fft),
        "sr": int(sr),
    }


def analyze_chunk(y: torch.Tensor, n_true: torch.Tensor, p_starts, p_nf,
                  f_starts, sr: int, n_fft: int, hop: int, f0_min: float,
                  f0_merge_range: int, with_formants: bool):
    """The whole analysis of a chunk of zero-padded waveforms ``y``
    (B, n_pad) as one batched pass on ``y``'s device.  Row b's true signal
    has ``n_true[b]`` samples, the pitch frame grid ``p_starts[b,
    :p_nf[b]]`` and the formant frame grid ``f_starts[b]`` (both padded by
    repeating the last start).

    Returns (env_spec (B, n_bins, T_pad), f0_interp (B, n_pad),
    voicing_mask (B, n_pad), tracks (B, 5, F_pad), knots16, chosen), the
    last two from _pick_knots; row b is meaningful up to its true sample
    and frame counts."""
    batch, n_pad = y.shape
    dev = y.device
    dt = hop / sr
    nt = n_true.long()

    # write the stft's right reflect pad at the TRUE end into the zero
    # padding, so even the boundary-straddling frames equal the unpadded
    # analysis: padded[n_true + k] = y[n_true - 2 - k]
    k = torch.arange(n_pad, device=dev) - nt[:, None]
    src = torch.clamp(nt[:, None] - 2 - k, 0, n_pad - 1)
    y_m = torch.where((k >= 0) & (k < n_fft // 2), torch.gather(y, 1, src), y)

    mag = stft(y_m, n_fft, hop).abs() + 1e-8
    env_spec = gaussian_blur1d(mag, 2.0, axis=-2)
    # true stft frame count: 1 + n_true // hop (center-padded framing)
    t_true = 1 + nt // hop

    f0_track = pitch_graph(y, sr, dt, PitchConfig(f0_min=f0_min), p_starts,
                           p_nf)
    f0_track = fix_f0_gaps(torch.nan_to_num(f0_track), f0_merge_range)
    # per-sample interp over the shared [0, duration] axis, with the TRUE
    # frame and sample counts (ref: GOOFER.py:960-963)
    nf = p_nf.float()[:, None]
    pos = (torch.arange(n_pad, dtype=torch.float32, device=dev)
           * (torch.clamp(nf - 1.0, min=0.0)
              / torch.clamp(n_true.float()[:, None] - 1.0, min=1.0)))
    pos = torch.minimum(pos, nf - 1.0)
    f0_interp = gather_lerp(f0_track, pos, axis=-1)
    f0_interp = torch.where(nf > 1, f0_interp, f0_track[:, :1])
    f0_interp = torch.clamp(f0_interp, config.F0_CLIP_LO, config.F0_CLIP_HI)
    voicing_mask = (f0_interp > f0_min).float()

    if with_formants:
        tracks = formant_graph(y, sr, dt, starts=f_starts, n_true=nt)
    else:
        tracks = torch.zeros((batch, 5, f_starts.shape[1]),
                             dtype=torch.float32, device=dev)

    # knot codec error sweep at 256 check columns of the TRUE range
    cpos = torch.round(torch.arange(256, dtype=torch.float32, device=dev)
                       * (t_true.float()[:, None] - 1.0) / 255.0).long()
    errs, log_env, _ = knot_errors(env_spec, sr, n_fft, check_idx=cpos)
    knots16, chosen = _pick_knots(log_env, errs, sr, n_fft)
    return env_spec, f0_interp, voicing_mask, tracks, knots16, chosen


def chunk_plan(lengths, hop: int, max_files: int, max_frames: int):
    """Group file indices by padded length and cut each group into chunks
    of at most ``max_files`` files and ``max_frames`` padded frames (one
    file at least).  Yields (n_pad, [index, ...])."""
    by_bucket: dict = {}
    for i, n in enumerate(lengths):
        # +8 hops margin keeps the trailing pad past the true-end reflect
        # pad and the analysis windows' reach
        by_bucket.setdefault(config.bucket_len(n + 8 * hop), []).append(i)
    for n_pad, group in sorted(by_bucket.items()):
        per_file = n_pad // hop + 2
        step = max(1, min(max_files, max_frames // per_file))
        for c0 in range(0, len(group), step):
            yield n_pad, group[c0:c0 + step]


def chunk_inputs(ys, n_pad: int, sr: int, hop: int, f0_min: float = 75.0):
    """Host inputs of one chunk of analyze_chunk: the waveforms ``ys``
    zero-padded to (B, n_pad) float32, their true sample counts (B,)
    int32, and each file's pitch and formant frame grids, computed from
    its TRUE length and padded to n_pad // hop + 2 frames.  Returns (y,
    n_true, p_starts, p_nf, f_starts, f_nf)."""
    cfg = PitchConfig(f0_min=f0_min)
    dt = hop / sr
    f_pad = n_pad // hop + 2
    yb = np.zeros((len(ys), n_pad), dtype=np.float32)
    p_grids, f_grids = [], []
    for j, y in enumerate(ys):
        n = len(y)
        yb[j, :n] = y
        wlen = min(pitch_window_len(sr, cfg), max(16, n))
        p_grids.append(_frame_grid(n, sr, dt, wlen))
        f_grids.append(formant_frame_grid(n, sr, dt))
    n_true = np.array([len(y) for y in ys], dtype=np.int32)
    return (yb, n_true, *padded_grid(p_grids, f_pad),
            *padded_grid(f_grids, f_pad))


def _extract_rows(ys, n_pad: int, sr: int, n_fft: int, hop: int,
                  f0_min: float, f0_merge_range: int, with_formants: bool,
                  dense: bool, device) -> list:
    """Files ``ys`` of one chunk (padded to ``n_pad``) as one
    analyze_chunk pass on ``device``: their per-file result tuples, as
    extract_features_batch returns them."""
    yb, n_true, p_starts, p_nf, f_starts, f_nf = chunk_inputs(
        ys, n_pad, sr, hop, f0_min)
    env, f0, mask, tracks, knots16, chosen = analyze_chunk(
        *(torch.as_tensor(a, device=device)
          for a in (yb, n_true, p_starts, p_nf, f_starts)),
        int(sr), n_fft, hop, float(f0_min), int(f0_merge_range),
        bool(with_formants))
    env = env.cpu().numpy() if dense else None
    f0, mask, tracks, knots16, chosen = (
        t.cpu().numpy() for t in (f0, mask, tracks, knots16, chosen))

    results = []
    for j in range(len(ys)):
        n = int(n_true[j])
        t_true = 1 + n // hop
        tr = tracks[j, :, :int(f_nf[j])]
        if tr.shape[1] < t_true:
            tr = np.pad(tr, ((0, 0), (0, t_true - tr.shape[1])))
        else:
            tr = tr[:, :t_true]
        results.append((
            None if env is None else env[j, :, :t_true],
            f0[j, :n].astype(np.float64),
            mask[j, :n].astype(np.float64),
            {k + 1: tr[k] for k in range(tr.shape[0])},
            _knot_pack(knots16[j], chosen[j], sr, n_fft, t_true)))
    return results


def extract_features_batch(ys, sr: int, n_fft: int = 1024,
                           hop_length: int = 256, f0_min: float = 75.0,
                           f0_merge_range: int = 2,
                           with_formants: bool = True,
                           chunk: int = EXTRACT_CHUNK_FILES,
                           dense: bool = True, device=None, mesh=None):
    """Batched feature extraction of ``ys``, a list of 1-D float arrays at
    a common sample rate, on ``device`` (None: config.get_device()).
    Returns a list of per-file tuples (env_spec, f0_interp, voicing_mask,
    formants, env_knots) with the reference's shapes and dtypes (NumPy):
    env_spec (n_bins, T) float32, f0_interp and voicing_mask (n,)
    float64, formants {1..5: (T,) float32}, env_knots the ``.goofy`` knot
    dict.

    ``dense=False`` (folder extraction): the dense envelope stays on the
    device and env_spec comes back None; everything else is the same.

    ``mesh`` (a parallel.mesh.Mesh, not together with ``device``) splits
    each chunk's files into contiguous shards over the mesh's slots, each
    shard one analyze_chunk pass on its slot's device at the chunk's
    padded length (devices.run_on_slots): a row's features do not depend
    on the rows beside it, so the files come back as from one device."""
    if mesh is not None and device is not None:
        raise ValueError("extract_features_batch: pass device= or mesh=, "
                         "not both")
    slots = (mesh.slots if mesh is not None
             else [config.get_device(device)])
    ys = [np.asarray(y, dtype=np.float32) for y in ys]
    tasks = [[] for _ in slots]
    order = [[] for _ in slots]
    for n_pad, part in chunk_plan([len(y) for y in ys], hop_length, chunk,
                                  EXTRACT_CHUNK_FRAMES):
        for s, (lo, hi) in enumerate(shard_bounds(len(part), len(slots))):
            if hi > lo:
                tasks[s].append(partial(
                    _extract_rows, [ys[i] for i in part[lo:hi]], n_pad,
                    int(sr), n_fft, hop_length, f0_min, f0_merge_range,
                    with_formants, dense, slots[s]))
                order[s].append(part[lo:hi])
    results: list = [None] * len(ys)
    for idx, done in zip(order, run_on_slots(slots, tasks)):
        for files, rows in zip(idx, done):
            for i, row in zip(files, rows):
                results[i] = row
    return results


def extract_features(y, sr: int, n_fft: int = 1024, hop_length: int = 256,
                     f0_min: float = 75.0, f0_merge_range: int = 2,
                     with_formants: bool = True, dense: bool = True,
                     device=None):
    """Returns (env_spec, f0_interp, voicing_mask, formants, env_knots)
    of one signal: a batch of one (see extract_features_batch)."""
    return extract_features_batch(
        [y], sr, n_fft, hop_length, f0_min, f0_merge_range, with_formants,
        dense=dense, device=device)[0]


def from_jax_features(features):
    """What goofer_tpu.analysis.features.extract_features returns, as this
    package's extract_features returns it: host NumPy arrays of the same
    dtypes, so a test can feed either package's features to the other's
    renderer."""
    env, f0_interp, voicing_mask, formants, knots = features
    knots = dict(knots,
                 knot_vals_log=np.asarray(knots["knot_vals_log"], np.float16),
                 hz_knots=np.asarray(knots["hz_knots"], np.float32))
    return (None if env is None else np.asarray(env, dtype=np.float32),
            np.asarray(f0_interp, dtype=np.float64),
            np.asarray(voicing_mask, dtype=np.float64),
            {int(k): np.asarray(v, dtype=np.float32)
             for k, v in formants.items()},
            knots)
