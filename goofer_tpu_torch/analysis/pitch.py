"""Autocorrelation pitch tracker (Boersma-style), replacing Praat's C++
``to_pitch`` AC method (ref: GOOFER.py:341-353, called with floor 75 Hz /
ceiling 950 Hz / time_step = hop/sr).

Port of goofer_tpu/analysis/pitch.py.  Algorithm: Hann-windowed frames of
3/f0_min seconds, autocorrelation via rfft normalized by the window's own
autocorrelation, parabolic peak refinement, top-K voiced candidates with
Boersma's octave-cost corrected strengths plus an unvoiced candidate, then
a Viterbi path over frames with octave-jump and voiced/unvoiced transition
costs.

Every function takes a leading batch axis: ``y`` is (B, n), one file per
row.  Rows of different true lengths ride one batch padded with zeros;
each row carries the frame grid of its TRUE length (``starts`` padded by
repeating its last entry) and its true frame count ``nf``.  Windows never
read padding, and the Viterbi stops at ``nf``, so a padded row's track
equals the file's alone.

Frames are one gather of rows from a strided view of the waveform
(``frames_at``); goofer_tpu's hop-block framing exists to dodge a TPU
gather cost and is not ported.  The Viterbi is the classic sequential
solve with a backtrace: ``viterbi_plain`` here on tensors, and the CUDA
kernel behind ops/cuda/viterbi_kernel.py on the card; goofer_tpu's
max-plus associative scan is a TPU form of the same path and agrees with
it away from exact score ties.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class PitchConfig:
    f0_min: float = 75.0
    f0_max: float = 950.0
    periods_per_window: float = 3.0
    max_candidates: int = 6           # voiced candidates kept per frame
    silence_threshold: float = 0.03   # Praat defaults
    voicing_threshold: float = 0.45
    octave_cost: float = 0.01
    octave_jump_cost: float = 0.35
    voiced_unvoiced_cost: float = 0.14


def _frame_grid(n_samples: int, sr: float, dt: float, wlen: int):
    """Praat-style centered frame grid: as many frames of length wlen as fit,
    centered in the signal.

    When the stride dt*sr is an integer (every production config: dt =
    hop/sr), starts are EXACTLY regular, clip(s0 + k*hop), instead of
    per-frame rounding of float centers, whose last-bit wobble made
    interior starts jitter by +-1 sample."""
    duration = n_samples / sr
    wdur = wlen / sr
    n_frames = max(1, int(np.floor((duration - wdur) / dt)) + 1)
    t1 = (duration - (n_frames - 1) * dt) / 2.0
    centers = t1 + dt * np.arange(n_frames)
    hop_f = dt * sr
    if abs(hop_f - round(hop_f)) < 1e-6:
        s0 = int(round(t1 * sr - wlen / 2.0))
        starts = s0 + int(round(hop_f)) * np.arange(n_frames, dtype=np.int64)
    else:
        starts = np.round(centers * sr - wlen / 2.0).astype(np.int64)
    starts = np.clip(starts, 0, max(0, n_samples - wlen))
    return n_frames, starts, centers


def pitch_window_len(sr: float, cfg: PitchConfig = PitchConfig()) -> int:
    """Static analysis window length for this sr/config."""
    return int(round(cfg.periods_per_window / cfg.f0_min * sr))


def padded_grid(grids, f_pad: int | None = None):
    """Stack per-file (n_frames, starts, ...) grids into (B, F) int64
    starts, each row padded by repeating its last start, and (B,) int32
    true frame counts."""
    nf = np.array([g[0] for g in grids], dtype=np.int32)
    f_pad = int(nf.max()) if f_pad is None else f_pad
    starts = np.zeros((len(grids), f_pad), dtype=np.int64)
    for j, g in enumerate(grids):
        starts[j, :g[0]] = g[1]
        starts[j, g[0]:] = g[1][-1]
    return starts, nf


def frames_at(y: torch.Tensor, starts: torch.Tensor,
              wlen: int) -> torch.Tensor:
    """frames[b, k] = y[b, starts[b, k] : starts[b, k] + wlen] for (B, n)
    ``y`` and (B, F) int64 ``starts``; returns (B, F, wlen).  Starts clamp
    into the row, and a row shorter than ``wlen`` reads zeros past its
    end."""
    if y.shape[-1] < wlen:
        y = torch.nn.functional.pad(y, (0, wlen - y.shape[-1]))
    starts = torch.clamp(starts, 0, y.shape[-1] - wlen)
    windows = y.unfold(-1, wlen, 1)                 # a view: (B, n-wlen+1, wlen)
    rows = torch.arange(y.shape[0], device=y.device)[:, None]
    return windows[rows, starts]


@functools.lru_cache(maxsize=None)
def _window_autocorr(wlen: int, nfft: int) -> np.ndarray:
    """The Hann window's normalized autocorrelation (host constant)."""
    w = np.hanning(wlen).astype(np.float64)
    wac = np.fft.irfft(np.abs(np.fft.rfft(w, n=nfft)) ** 2, n=nfft)
    wac = (wac / wac[0]).astype(np.float32)
    return np.where(np.abs(wac) > 1e-6, wac, 1e-6).astype(np.float32)


def _candidates(y: torch.Tensor, sr: float, wlen: int, nfft: int,
                cfg: PitchConfig, starts: torch.Tensor):
    """Per-frame voiced candidates of (B, n) ``y`` on (B, F) ``starts``:
    (freq (B, F, K), strength (B, F, K), local peak (B, F)).  Lags that are
    no peak carry strength -1e9; which of them fill a frame's spare slots
    is ``torch.topk``'s choice and carries no meaning."""
    lag_min = max(2, int(np.floor(sr / cfg.f0_max)))
    lag_max = int(np.ceil(sr / cfg.f0_min))
    lag_max = min(lag_max, wlen - 2)
    dev = y.device

    frames = frames_at(y, starts, wlen)                       # (B, F, wlen)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    local_peak = frames.abs().amax(dim=-1)

    window = torch.as_tensor(np.hanning(wlen).astype(np.float32), device=dev)
    spec = torch.fft.rfft(frames * window, n=nfft, dim=-1)
    ac = torch.fft.irfft(spec * spec.conj(), n=nfft, dim=-1)
    r0 = torch.clamp(ac[..., 0:1], min=1e-12)

    # normalization, peak picking and refinement only over the candidate
    # lag band [lag_min, lag_max], ~13% of the nfft lags
    band = slice(lag_min - 1, lag_max + 2)
    wac = torch.as_tensor(_window_autocorr(wlen, nfft)[band], device=dev)
    seg = (ac[..., band] / r0) / wac                          # (B, F, L+2)
    rm1 = seg[..., :-2]
    rc = seg[..., 1:-1]
    rp1 = seg[..., 2:]
    lags = torch.arange(lag_min, lag_max + 1, device=dev)
    is_peak = (rc > rm1) & (rc >= rp1)

    # parabolic refinement around each lag
    denom = rm1 - 2.0 * rc + rp1
    dlag = torch.where(denom.abs() > 1e-12, 0.5 * (rm1 - rp1) / denom, 0.0)
    dlag = torch.clamp(dlag, -0.5, 0.5)
    r_ref = rc - 0.25 * (rm1 - rp1) * dlag
    lag_ref = lags + dlag

    freq = sr / torch.clamp(lag_ref, min=1e-6)
    # Boersma's octave-cost corrected local strength
    strength = r_ref - cfg.octave_cost * torch.log2(
        torch.clamp(cfg.f0_min * lag_ref / sr, min=1e-12))
    strength = torch.where(is_peak, strength, -1e9)

    top_s, top_i = torch.topk(strength, cfg.max_candidates, dim=-1)
    top_f = torch.gather(freq, -1, top_i)
    top_f = torch.clamp(top_f, cfg.f0_min * 0.5, cfg.f0_max)
    return top_f, top_s, local_peak


def transition_costs(cfg: PitchConfig, dt: float) -> tuple[float, float]:
    """(voiced/unvoiced cost, octave-jump cost) per frame step of ``dt``
    seconds, each rounded to float32 as the Viterbi applies them."""
    dt_ratio = np.float32(dt / 0.01)
    return (float(np.float32(cfg.voiced_unvoiced_cost) * dt_ratio),
            float(np.float32(cfg.octave_jump_cost) * dt_ratio))


def viterbi_plain(freqs: torch.Tensor, strengths: torch.Tensor,
                  unvoiced_strength: torch.Tensor, nf: torch.Tensor,
                  vu_cost: float, oj_cost: float):
    """Max-sum path over (K voiced + 1 unvoiced) states per frame: the
    sequential solve, forward scores with backpointers and a backtrace,
    batched over the rows of (B, F, K) ``freqs`` and ``strengths`` and
    (B, F) ``unvoiced_strength``.

    Row b stops at its true frame count ``nf[b]``: its last state is the
    best at frame nf[b] - 1.  The cost between state i at t - 1 and j at t
    is ``oj_cost`` * |log2(f_prev / f_next)| between two voiced states,
    ``vu_cost`` between a voiced and the unvoiced state, 0 between two
    unvoiced; the maximum takes the first of equal scores.  All float32,
    in the order of operations of csrc/pitch_viterbi.cu, which gives the
    same path bit for bit.

    Returns (f0 (B, F) float32, 0 where unvoiced and past nf; path (B, F)
    int64 state indices, K for unvoiced, -1 past nf)."""
    batch, n_frames, k = freqs.shape
    s_all = torch.cat([strengths, unvoiced_strength[..., None]], dim=-1)
    f_all = torch.cat([freqs, torch.zeros_like(freqs[..., :1])], dim=-1)
    frame = torch.arange(n_frames, device=freqs.device)
    valid = frame[None, :] < nf[:, None]                      # (B, F)

    f_prev = f_all[:, :-1, :, None]
    f_next = f_all[:, 1:, None, :]
    pv = f_prev > 0
    nv = f_next > 0
    jump = oj_cost * torch.abs(torch.log2(
        torch.clamp(f_prev, min=1e-6) / torch.clamp(f_next, min=1e-6)))
    cost = torch.where(pv & nv, jump,
                       torch.where(pv ^ nv, vu_cost, 0.0))    # (B, F-1, S, S)

    delta = s_all[:, 0]
    back = torch.zeros((batch, n_frames, k + 1), dtype=torch.int64,
                       device=freqs.device)
    for t in range(1, n_frames):
        best, arg = (delta[:, :, None] - cost[:, t - 1]).max(dim=1)
        live = valid[:, t, None]
        delta = torch.where(live, s_all[:, t] + best, delta)
        back[:, t] = arg
    state = delta.argmax(dim=1)
    path = torch.empty((batch, n_frames), dtype=torch.int64,
                       device=freqs.device)
    path[:, -1] = state
    for t in range(n_frames - 1, 0, -1):
        step = torch.gather(back[:, t], 1, state[:, None])[:, 0]
        state = torch.where(valid[:, t], step, state)
        path[:, t - 1] = state
    f0 = torch.gather(f_all, 2, path[..., None])[..., 0]
    return torch.where(valid, f0, 0.0), torch.where(valid, path, -1)


def viterbi_inputs(y: torch.Tensor, sr: float, dt: float,
                   cfg: PitchConfig = PitchConfig(), starts=None, nf=None):
    """What the Viterbi takes for (B, n) waveforms: (freqs (B, F, K),
    strengths (B, F, K), unvoiced_strength (B, F), nf (B,) int32), all
    contiguous.  ``starts`` and ``nf`` as for pitch_graph."""
    y = y.float()
    batch, n = y.shape
    wlen = min(pitch_window_len(sr, cfg), max(16, n))
    nfft = 1
    while nfft < 2 * wlen:
        nfft *= 2
    if starts is None:
        n_frames, grid, _ = _frame_grid(n, sr, dt, wlen)
        starts = torch.as_tensor(grid, device=y.device).expand(batch, -1)
        nf = torch.full((batch,), n_frames, device=y.device)
    freqs, strengths, local_peak = _candidates(y, float(sr), wlen, nfft, cfg,
                                               starts)

    global_peak = torch.clamp(y.abs().amax(dim=-1, keepdim=True), min=1e-12)
    intensity = local_peak / global_peak
    unvoiced_strength = cfg.voicing_threshold + torch.clamp(
        2.0 - (intensity * (1.0 + cfg.voicing_threshold)
               / cfg.silence_threshold), min=0.0)
    return (freqs.contiguous(), strengths.contiguous(),
            unvoiced_strength.contiguous(), nf.to(torch.int32))


def pitch_graph(y: torch.Tensor, sr: float, dt: float,
                cfg: PitchConfig = PitchConfig(), starts=None,
                nf=None) -> torch.Tensor:
    """Frame-rate F0 tracks (B, F) of (B, n) waveforms, 0 where unvoiced.

    Without ``starts`` every row is a whole signal of n samples.  With
    ``starts`` (B, F) and ``nf`` (B,), row b is a zero-padded waveform
    whose true signal has the frame grid ``starts[b, :nf[b]]``: the track
    on its true frames equals the unpadded signal's, and is 0 past
    them."""
    from goofer_tpu_torch.ops.cuda.viterbi_kernel import pitch_viterbi

    vu_cost, oj_cost = transition_costs(cfg, dt)
    return pitch_viterbi(*viterbi_inputs(y, sr, dt, cfg, starts, nf),
                         vu_cost, oj_cost)[0]


def track_pitch(y, sr: float, dt: float, cfg: PitchConfig = PitchConfig(),
                device=None) -> np.ndarray:
    """Frame-rate F0 track in Hz of one signal, 0 where unvoiced."""
    from goofer_tpu_torch import config

    y = torch.as_tensor(np.asarray(y, dtype=np.float32),
                        device=config.get_device(device))
    return pitch_graph(y[None], sr, dt, cfg)[0].cpu().numpy()


def fix_f0_gaps(f0: torch.Tensor, max_gap: int = 4) -> torch.Tensor:
    """Bridge interior zero-runs of length <= max_gap along the last axis
    by linear interpolation (ref: GOOFER.py:415-435), through two-sided
    nearest-valid scans."""
    f0 = f0.float()
    n = f0.shape[-1]
    valid = f0 != 0.0
    i = torch.arange(n, dtype=torch.float32, device=f0.device).expand_as(f0)

    left_idx = torch.cummax(torch.where(valid, i, -1.0), dim=-1).values
    right_idx = -torch.cummax(
        torch.where(valid, -i, -(2.0 * n)).flip(-1), dim=-1).values.flip(-1)

    left_ok = left_idx >= 0
    right_ok = right_idx < n
    gap_len = right_idx - left_idx - 1.0
    fillable = (~valid) & left_ok & right_ok & (gap_len <= max_gap)

    left_val = torch.gather(f0, -1, torch.clamp(left_idx, min=0).long())
    left_val = torch.where(left_ok, left_val, 0.0)
    right_val = torch.gather(f0, -1, torch.clamp(right_idx, max=n - 1).long())
    right_val = torch.where(right_ok, right_val, 0.0)
    ratio = (i - left_idx) / torch.clamp(right_idx - left_idx, min=1.0)
    bridged = left_val * (1.0 - ratio) + right_val * ratio
    return torch.where(fillable, bridged, f0)
