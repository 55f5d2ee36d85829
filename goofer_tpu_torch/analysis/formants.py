"""Burg-LPC formant tracker, replacing Praat's C++ ``to_formant_burg``
(ref: GOOFER.py:768-792, called with time_step = hop/sr, max 5 formants).

Port of goofer_tpu/analysis/formants.py.  Praat-equivalent pipeline,
batched over files (the leading axis of ``y`` (B, n)) and frames:

1. anti-alias lowpass + exact decimation to about 2 * max_formant_hz
   (11 025 Hz for the 5.5 kHz default ceiling at 44.1 kHz);
2. pre-emphasis from 50 Hz;
3. Gaussian-windowed frames of 2 * 0.025 s, Burg recursion of order
   2 * max_formants;
4. polynomial roots by Durand-Kerner iteration;
5. root angles -> formant frequencies, filtered to [50, nyquist-50] and
   sorted ascending; missing formants are 0.0 like the reference's
   None -> 0.0 mapping (ref: GOOFER.py:778-781).

Steps 3 and 4 are hand kernels on the card (ops/cuda/burg_kernel.py,
ops/cuda/lpc_roots_kernel.py); ``burg_coeffs_plain`` and
``poly_roots_dk_plain`` are their plain versions, the same loops on
tensors.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from goofer_tpu_torch.analysis.pitch import frames_at


def _lowpass_kernel(cutoff_frac: float, taps: int = 127) -> np.ndarray:
    """Windowed-sinc FIR lowpass; cutoff as a fraction of Nyquist."""
    m = np.arange(taps) - (taps - 1) / 2.0
    h = np.sinc(cutoff_frac * m) * cutoff_frac
    h *= np.hamming(taps)
    return (h / h.sum()).astype(np.float32)


def _formant_decim(sr: float, max_formant_hz: float) -> int:
    """Integer decimation factor for the Burg analysis rate: the largest
    power of two <= sr / (2*max_formant_hz).
    44.1k -> 4 (11025 Hz), 48k -> 4 (12000 Hz), 22.05k -> 2 (11025 Hz).
    The analysis rate lands slightly ABOVE Praat's exact 2*ceiling
    resample (11025 vs 11000 at 44.1k, <0.3%, far inside the formant
    budgets); in exchange the decimation is an exact strided filter and
    the frame stride hop/decim stays integral, as in goofer_tpu."""
    d = 1
    while d * 2 <= 256 and sr / (d * 2) >= 2.0 * max_formant_hz:
        d *= 2
    return d


def _decimate(y: torch.Tensor, sr: float, decim: int, n_true=None):
    """Anti-aliased exact decimation of (B, n) rows: the 127-tap FIR
    lowpass over the edge-padded signal, evaluated at every ``decim``-th
    sample (ops/filters.py:fir_decimate).  With ``n_true`` (B,), row b
    holds its last true sample past ``n_true[b]``, the edge padding of the
    true signal, so its decimated samples equal the unpadded file's."""
    from goofer_tpu_torch.ops.filters import fir_decimate

    if decim <= 1:
        return y, sr
    if n_true is not None:
        idx = torch.arange(y.shape[-1], device=y.device)
        last = torch.gather(y, 1, torch.clamp(n_true.long() - 1, min=0)[:, None])
        y = torch.where(idx >= n_true[:, None], last, y)
    return fir_decimate(y, _lowpass_kernel(1.0 / decim), decim), sr / decim


def burg_coeffs_plain(frames: torch.Tensor, order: int) -> torch.Tensor:
    """Batched Burg recursion.  frames: (rows, wlen) windowed; returns LPC
    polynomial coefficients a[0..order] with a[0] = 1, shape
    (rows, order + 1)."""
    rows, wlen = frames.shape
    f = frames
    b = frames
    a = torch.zeros((rows, order + 1), dtype=torch.float32,
                    device=frames.device)
    a[:, 0] = 1.0
    col = torch.arange(wlen, device=frames.device)
    for m in range(1, order + 1):
        # active region: indices m..wlen-1 for f, m-1..wlen-2 for b(shifted)
        mask = (col >= m).float()
        b_sh = torch.roll(b, 1, dims=1)            # b[i-1] aligned with f[i]
        num = (f * b_sh * mask).sum(dim=1)
        den = ((f * f + b_sh * b_sh) * mask).sum(dim=1)
        k = (-2.0 * num / torch.clamp(den, min=1e-20))[:, None]
        f, b = (f + k * b_sh) * mask, (b_sh + k * f) * mask
        # a_new[i] = a[i] + k * a[m - i], i <= m
        a_ref = torch.zeros_like(a)
        a_ref[:, :m + 1] = a[:, :m + 1].flip(1)
        a = a + k * a_ref
    return a


def poly_roots_dk_plain(coeffs: torch.Tensor, iters: int = 60) -> torch.Tensor:
    """Batched Durand-Kerner root finder.  coeffs: (rows, order + 1),
    monic leading coefficient required.  Returns (rows, order) complex64
    roots after ``iters`` iterations from 0.9 e^{i 2 pi (k + 0.25) / order}."""
    rows, order = coeffs.shape[0], coeffs.shape[1] - 1
    dev = coeffs.device
    c = coeffs.to(torch.complex64)
    angles = 2.0 * np.pi * (np.arange(order) + 0.25) / order
    z0 = (0.9 * np.exp(1j * angles)).astype(np.complex64)
    z = torch.as_tensor(z0, device=dev).expand(rows, order)
    eye = torch.eye(order, dtype=torch.complex64, device=dev)
    tiny = torch.tensor(1e-20, dtype=torch.complex64, device=dev)
    for _ in range(iters):
        pz = _poly_eval(c, z)
        diff = z[:, :, None] - z[:, None, :] + eye             # (rows, r, r)
        denom = diff[:, :, 0]
        for j in range(1, order):
            denom = denom * diff[:, :, j]
        z = z - pz / torch.where(denom.abs() < 1e-20, tiny, denom)
    return z


def _poly_eval(c: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Horner evaluation of the complex polynomials c (rows, order + 1),
    leading coefficient first, at z (rows, r)."""
    out = torch.zeros_like(z) + c[:, 0:1]
    for i in range(1, c.shape[1]):
        out = out * z + c[:, i:i + 1]
    return out


def formant_frame_grid(n_samples: int, sr: float, dt: float,
                       max_formant_hz: float = 5500.0,
                       window_half_sec: float = 0.025):
    """Host-side Praat-style centered frame grid in the DECIMATED domain
    (the Burg analysis runs at sr / _formant_decim).  Starts are exactly
    regular, clip(s0 + k*hop2), when the decimated stride is integral
    (every production config).  Returns
    (n_frames, starts, wlen, n_resampled)."""
    decim = _formant_decim(sr, max_formant_hz)
    sr2 = sr / decim
    n = -(-int(n_samples) // decim) if decim > 1 else int(n_samples)
    wlen = int(round(2.0 * window_half_sec * sr2))
    wlen = min(wlen, max(32, n))
    duration = n / sr2
    n_frames = max(1, int(np.floor((duration - wlen / sr2) / dt)) + 1)
    t1 = (duration - (n_frames - 1) * dt) / 2.0
    hop_f = dt * sr2
    if abs(hop_f - round(hop_f)) < 1e-6:
        s0 = int(round(t1 * sr2 - wlen / 2.0))
        starts = s0 + int(round(hop_f)) * np.arange(n_frames,
                                                    dtype=np.int64)
    else:
        starts = np.round((t1 + dt * np.arange(n_frames)) * sr2
                          - wlen / 2).astype(np.int64)
    starts = np.clip(starts, 0, max(0, n - wlen))
    return n_frames, starts, wlen, n


def lpc_frames(y: torch.Tensor, sr: float, dt: float,
               max_formant_hz: float = 5500.0,
               window_half_sec: float = 0.025, starts=None, n_true=None):
    """The Burg recursion's input for (B, n) waveforms: decimated,
    pre-emphasised, mean-free, Gaussian-windowed frames (B, F, wlen), and
    the analysis rate.  ``starts`` and ``n_true`` as for formant_graph."""
    y = y.float()
    decim = _formant_decim(float(sr), max_formant_hz)
    y_rs, sr2 = _decimate(y, float(sr), decim, n_true)
    n = int(y_rs.shape[-1])

    # pre-emphasis from 50 Hz
    pre = float(np.exp(-2.0 * np.pi * 50.0 / sr2))
    y_pe = y_rs - pre * F.pad(y_rs[:, :-1], (1, 0))

    wlen = int(round(2.0 * window_half_sec * sr2))
    wlen = min(wlen, max(32, n))
    if starts is None:
        _, grid, wlen, _ = formant_frame_grid(
            y.shape[-1], sr, dt, max_formant_hz, window_half_sec)
        starts = torch.as_tensor(grid, device=y.device).expand(y.shape[0], -1)

    frames = frames_at(y_pe, starts, wlen)                  # (B, F, wlen)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    # Praat's Gaussian analysis window
    tgrid = (np.arange(wlen) - (wlen - 1) / 2.0) / ((wlen - 1) / 2.0)
    gwin = ((np.exp(-12.0 * tgrid ** 2) - np.exp(-12.0))
            / (1.0 - np.exp(-12.0))).astype(np.float32)
    return frames * torch.as_tensor(gwin, device=y.device), sr2


def converged_roots(a: torch.Tensor, roots: torch.Tensor) -> torch.Tensor:
    """The convergence guard of the fixed Durand-Kerner iteration budget:
    True where a root's polynomial residual is within 1e-3 of the
    coefficients' scale."""
    pz = _poly_eval(a.to(torch.complex64), roots)
    coeff_scale = a.abs().sum(dim=1, keepdim=True) + 1e-12
    return pz.abs() <= 1e-3 * coeff_scale


def formant_graph(y: torch.Tensor, sr: float, dt: float,
                  max_formants: int = 5, max_formant_hz: float = 5500.0,
                  window_half_sec: float = 0.025,
                  starts=None, n_true=None) -> torch.Tensor:
    """Formant tracks (B, max_formants, F) of (B, n) waveforms, 0.0 where
    missing.

    Without ``starts`` every row is a whole signal of n samples.
    ``starts`` (B, F) (decimated-domain frame starts, each row padded by
    repeating its last entry) and ``n_true`` (B,) give row b the grid and
    the sample count of its TRUE signal while ``y`` carries trailing zero
    padding; frames past a row's true count repeat its last frame, and the
    caller discards them."""
    from goofer_tpu_torch.ops.cuda.burg_kernel import burg_lpc
    from goofer_tpu_torch.ops.cuda.lpc_roots_kernel import lpc_roots

    frames, sr2 = lpc_frames(y, sr, dt, max_formant_hz, window_half_sec,
                             starts, n_true)
    batch, _, wlen = frames.shape
    a = burg_lpc(frames.reshape(-1, wlen).contiguous(), 2 * max_formants)
    roots = lpc_roots(a)

    # a root whose residual stayed large is junk: drop it so the frame
    # reports 0.0 for that formant, matching the reference's None->0.0
    # semantics (ref: GOOFER.py:777-781) instead of shipping noise
    freqs = torch.angle(roots) * (sr2 / (2.0 * np.pi))      # (B*F, order)
    nyq = sr2 / 2.0
    ok = (freqs > 50.0) & (freqs < nyq - 50.0) & converged_roots(a, roots)
    freqs = torch.where(ok, freqs, torch.inf)
    freqs = torch.sort(freqs, dim=1).values[:, :max_formants]
    freqs = torch.where(torch.isfinite(freqs), freqs, 0.0)
    return freqs.reshape(batch, -1, max_formants).transpose(1, 2)


def track_formants(y, sr: float, dt: float, max_formants: int = 5,
                   max_formant_hz: float = 5500.0,
                   window_half_sec: float = 0.025,
                   target_frames: int | None = None,
                   device=None) -> np.ndarray:
    """Formant tracks of one signal, shape (max_formants, n_frames); 0.0
    where missing."""
    from goofer_tpu_torch import config

    y = torch.as_tensor(np.asarray(y, dtype=np.float32),
                        device=config.get_device(device))
    tracks = formant_graph(y[None], sr, dt, max_formants, max_formant_hz,
                           window_half_sec)[0].cpu().numpy()
    if target_frames is not None:
        cur = tracks.shape[1]
        if cur < target_frames:
            tracks = np.pad(tracks, ((0, 0), (0, target_frames - cur)))
        else:
            tracks = tracks[:, :target_frames]
    return tracks
