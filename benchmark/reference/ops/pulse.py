"""Frozen copy of goofer_tpu_torch/ops/pulse.py for the benchmark's plain reference:
the plain PyTorch versions of the hand kernels only.

LF glottal pulse train.

Port of goofer_tpu/ops/pulse.py.  The reference generates pulses with a
sequential per-sample phase accumulator (``pulse_train_numba``, ref:
GOOFER.py:473-554) and a per-ratio event tracker for subharmonics (ref:
GOOFER.py:672-746).  Reformulated as in goofer_tpu:

* phase = float64 ``cumsum(f0/sr)``, as the reference accumulates it
  (GOOFER.py:504-506); a pulse onset is a sample where ``floor(phase)``
  increases.  (goofer_tpu needs a TwoSum scan here only because TPUs
  have no float64.)
* compact onset tables: row r holds the (r+1)-th onset's position, its
  period in samples (T0) and seconds (T) from the reference's
  ``last_valid_f0`` carry, and the closed-form grid peak of its pulse;
* each sample sums the peak-normalized LF pulses of its K most recent
  onsets — the K-bounded sum of goofer_tpu's ``_accumulate_pulses``,
  which equals its blocked and Pallas forms whenever K bounds the true
  pulse overlap (the resampler derives K so that it does).

The whole pass, f0 in and pulse train out (phase, onsets, tables and
accumulation), is one launch of the Hopper kernel
``ops/cuda/pulse_kernel.py`` (``csrc/pulse_accumulate.cu``) per
``pulse_train`` and per semitone of ``subharm_pulse_train``;
``pulse_pass_plain`` below is its plain PyTorch version, the composition
of ``_onsets_from_phase``, ``_compact_onset_tables`` and
``accumulate_pulses_plain``, which the wrapper runs only for CPU tensors.
Everything keeps a leading batch dimension (B, n).
"""
from __future__ import annotations

import math

import torch

from benchmark.reference import config
from benchmark.reference.ops.interp import per_row


def lf_pulse_value(u: torch.Tensor, T: torch.Tensor, Ra: float, Rg: float,
                   Rk: float, guard: bool) -> torch.Tensor:
    """LF pulse at normalized position u = t/T in [0, 1).

    ``guard=True`` reproduces the epsilon guards of the Numba kernel
    (ref: GOOFER.py:514-517), scaled by the period T; ``guard=False``
    matches ``lf_model_pulse`` (ref: GOOFER.py:437-462)."""
    uc = Ra + Rk * (1.0 - Ra)
    if guard:
        rise = torch.sin(math.pi * u * T / (2.0 * Ra * T + 1e-12)) ** 2
        tau = (u - Ra) * T / ((uc - Ra) * T + 1e-12)
    else:
        rise = torch.sin(math.pi * u / (2.0 * Ra)) ** 2
        tau = (u - Ra) / (uc - Ra)
    decay = torch.exp(-Rg * tau) * torch.cos(math.pi * tau / 2.0)
    out = torch.where(u < Ra, rise, torch.where(u < uc, decay, 0.0))
    return torch.where((u >= 0.0) & (u < 1.0), out, 0.0)


def _grid_peak(T0: torch.Tensor, T: torch.Tensor, Ra: float, Rg: float,
               Rk: float, guard: bool) -> torch.Tensor:
    """max_j |p(j/T0)| in closed form (monotone rise then monotone decay):
    the maximum sits on one of the two grid points straddling u = Ra."""
    j_lo = torch.floor(Ra * T0)
    j_hi = torch.minimum(j_lo + 1.0, T0 - 1.0)
    p_lo = lf_pulse_value(j_lo / T0, T, Ra, Rg, Rk, guard)
    p_hi = lf_pulse_value(j_hi / T0, T, Ra, Rg, Rk, guard)
    return torch.clamp(torch.maximum(p_lo, p_hi), min=1e-12)


def _onsets_from_phase(phase: torch.Tensor) -> torch.Tensor:
    """True at samples where floor(phase) increased (integer crossing)."""
    k = torch.floor(phase)
    k_prev = torch.cat([torch.zeros_like(k[..., :1]), k[..., :-1]], dim=-1)
    return k > k_prev


def _last_valid_index(valid: torch.Tensor) -> torch.Tensor:
    """Index of the most recent valid sample <= i along the last axis,
    or -1."""
    n = valid.shape[-1]
    idx = torch.arange(n, device=valid.device).expand_as(valid)
    return torch.cummax(torch.where(valid, idx, -1), dim=-1).values


def forward_fill(values: torch.Tensor, valid: torch.Tensor,
                 init: float) -> torch.Tensor:
    """values[..., i] from the most recent valid index <= i along the
    last axis, else ``init``."""
    ff = _last_valid_index(valid)
    filled = torch.gather(values, -1, torch.clamp(ff, min=0))
    return torch.where(ff >= 0, filled,
                       torch.tensor(init, dtype=values.dtype,
                                    device=values.device))


def _compact_onset_tables(onset: torch.Tensor, f0: torch.Tensor,
                          valid_f0: torch.Tensor, fallback_f0: float,
                          sr: float, Ra: float, Rg: float, Rk: float,
                          guard: bool, min_spacing: int):
    """Compact per-generation onset tables from (B, n) onset/f0/validity.

    ``gen = cumsum(onset)`` is nondecreasing, so the sample of the
    (r+1)-th onset is ``searchsorted(gen, r+1)``.  The period at each
    onset is the reference's ``last_valid_f0`` carry (GOOFER.py:487-500),
    read only at the M table rows.  Every index is clamped before it is
    used: torch raises where jnp.take clamps silently.

    Returns (row (B, n) int32: table row of the latest onset <= i, -1
    before the first; pos, t0, t, norm tables (B, M) float32 with
    M = n // min_spacing + 2; rows past the last onset hold
    (4n, 1, 1, 1) and never contribute)."""
    n = onset.shape[-1]
    m = n // min_spacing + 2
    gen = torch.cumsum(onset.to(torch.int32), dim=-1, dtype=torch.int32)
    row = gen - 1
    queries = torch.arange(1, m + 1, dtype=torch.int32, device=onset.device)
    pos = torch.searchsorted(
        gen, queries.expand(gen.shape[:-1] + (m,)).contiguous(), side="left")
    valid = pos < n
    pos_c = torch.clamp(pos, max=n - 1)

    src = torch.gather(_last_valid_index(valid_f0), -1, pos_c)
    f0_src = torch.gather(f0.float(), -1, torch.clamp(src, min=0))
    f0_at = torch.where(src >= 0, f0_src, fallback_f0)
    t_g = 1.0 / torch.clamp(f0_at, min=1e-6)
    t0_g = torch.clamp(torch.round(sr * t_g), config.PULSE_T0_MIN,
                       config.PULSE_T0_MAX)

    pos_tab = torch.where(valid, pos.float(), float(4 * n))
    t0_tab = torch.where(valid, t0_g, 1.0)
    t_tab = torch.where(valid, t_g, 1.0)
    norm_tab = torch.where(valid, _grid_peak(t0_g, t_g, Ra, Rg, Rk, guard),
                           1.0)
    return row, pos_tab, t0_tab, t_tab, norm_tab


def accumulate_pulses_plain(row: torch.Tensor, pos_tab: torch.Tensor,
                            t0_tab: torch.Tensor, t_tab: torch.Tensor,
                            norm_tab: torch.Tensor, Ra: float, Rg: float,
                            Rk: float, guard: bool,
                            max_overlap: int) -> torch.Tensor:
    """Plain PyTorch version of the pulse-accumulation kernel:
    out[b, i] = sum over the K = ``max_overlap`` most recent table rows
    j = row[b, i] - k (0 <= j < M) of lf(u, T_j)/norm_j, u = (i-pos_j)/T0_j,
    for 0 <= i - pos_j < T0_j."""
    n = row.shape[-1]
    m = pos_tab.shape[-1]
    t_idx = torch.arange(n, dtype=torch.float32, device=row.device)
    out = torch.zeros(row.shape, dtype=torch.float32, device=row.device)
    for k in range(max_overlap):
        j = row.long() - k
        ok = (j >= 0) & (j < m)
        jc = torch.clamp(j, 0, m - 1)
        pos = torch.gather(pos_tab, -1, jc)
        t0 = torch.gather(t0_tab, -1, jc)
        ts = torch.gather(t_tab, -1, jc)
        nrm = torch.gather(norm_tab, -1, jc)
        offs = t_idx - pos
        val = lf_pulse_value(offs / t0, ts, Ra, Rg, Rk, guard) / nrm
        out = out + torch.where(ok & (offs >= 0.0) & (offs < t0), val, 0.0)
    return out


def pass_phase(f0: torch.Tensor, gate: torch.Tensor | None, sr: float,
               scale: float):
    """A pass's scaled f0 track, its validity and its float64 phase.  Main
    pass (``gate`` None): the phase advances every sample and f0 > 1e-6 is
    valid.  Gated pass: the phase advances, onsets fire and f0 counts as
    valid only where gate > 0, f0 > 0 and the scaled f0 >= 1e-2."""
    sub = f0 * scale
    if gate is None:
        valid = sub > 1e-6
        return sub, valid, torch.cumsum(sub.double() / sr, dim=-1)
    valid = (gate > 0) & (f0 > 0) & (sub >= 1e-2)
    phase = torch.cumsum(torch.where(valid, sub.double() / sr, 0.0), dim=-1)
    return sub, valid, phase


def pulse_pass_tables(f0: torch.Tensor, gate: torch.Tensor | None,
                      sr: float, scale: float, fallback_f0: float,
                      Ra: float, Rg: float, Rk: float, guard: bool,
                      min_spacing: int):
    """A pass's onsets as compact tables (see _compact_onset_tables)."""
    sub, valid, phase = pass_phase(f0, gate, sr, scale)
    onset = _onsets_from_phase(phase)
    if gate is not None:
        onset = onset & valid
    return _compact_onset_tables(onset, sub, valid, fallback_f0, sr,
                                 Ra, Rg, Rk, guard, min_spacing)


def pulse_pass_plain(f0: torch.Tensor, gate: torch.Tensor | None,
                     sr: float, scale: float, fallback_f0: float,
                     Ra: float, Rg: float, Rk: float, guard: bool,
                     max_overlap: int, min_spacing: int) -> torch.Tensor:
    """Plain PyTorch version of the pulse-pass kernel on (B, n) rows: the
    onset tables of ``f0 * scale`` (pulse_pass_tables) accumulated by
    accumulate_pulses_plain."""
    tables = pulse_pass_tables(f0, gate, sr, scale, fallback_f0, Ra, Rg, Rk,
                               guard, min_spacing)
    return accumulate_pulses_plain(*tables, Ra, Rg, Rk, guard, max_overlap)


def _as_batch(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).contiguous()


def pulse_train(f0: torch.Tensor, sr: float,
                Ra: float = config.PULSE_RA,
                Rg: float = config.PULSE_RG,
                Rk: float = config.PULSE_RK,
                fallback_f0: float = config.PULSE_FALLBACK_F0,
                max_overlap: int = config.PULSE_MAX_OVERLAP,
                min_spacing: int = config.PULSE_MIN_SPACING) -> torch.Tensor:
    """ARX-LF pulse train from a per-sample f0 track (..., n).

    Equivalent of ``pulse_train_numba`` (ref: GOOFER.py:473-554): phase
    accumulates f0/sr every sample (voiced or not); each integer crossing
    starts one peak-normalized LF pulse whose period comes from the most
    recent f0 > 1e-6 (initially ``fallback_f0``), clamped to [3, 8192]
    samples.  One kernel launch."""
    out = pulse_pass_plain(_as_batch(f0.float()), None, sr, 1.0,
                           fallback_f0, Ra, Rg, Rk, True, max_overlap,
                           min_spacing)
    return out.reshape(f0.shape)


def subharm_pulse_train(f0: torch.Tensor, sr: float, mask: torch.Tensor,
                        semitones, weight,
                        fallback_f0: float = config.PULSE_FALLBACK_F0,
                        max_overlap: int = 8,
                        min_spacing: int = 8) -> torch.Tensor:
    """Subharmonic pulse layer (ref: GOOFER.py:672-746) on (..., n) tracks.

    Per semitone ratio, a phase tracker accumulates ``sub_f0/sr`` on
    voiced samples only and fires an LF pulse (Ra=0.02, Rg=1.7, Rk=1) at
    each integer crossing: one kernel launch for all rows, gated by the
    voicing mask.  Each row's sum is gated by its mask, peak-normalized
    over the row, then scaled by ``weight`` (a float, or (B,) per row of a
    (B, n) batch)."""
    f0 = f0.float()
    mask = mask.float()
    if not isinstance(semitones, (list, tuple)):
        semitones = [semitones]
    # at active samples the reference's forward-filled last_f0 equals the
    # current f0, and onsets only fire at active samples, so the filled
    # track is never read where it differs from f0 * ratio
    f0_rows = _as_batch(f0)
    gate = _as_batch(torch.broadcast_to(mask, f0.shape))

    total = torch.zeros_like(f0)
    for semi in semitones:
        ratio = 2.0 ** (float(semi) / 12.0)
        total = total + pulse_pass_plain(
            f0_rows, gate, sr, ratio, fallback_f0 * ratio, 0.02, 1.7, 1.0,
            False, max_overlap, min_spacing).reshape(f0.shape)

    total = total * mask
    peak = torch.amax(torch.abs(total), dim=-1, keepdim=True)
    total = torch.where(peak > 1e-6, total / peak, total)
    return total * per_row(weight)
