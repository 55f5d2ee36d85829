"""Batched note rendering over a mesh of devices.

Port of goofer_tpu/parallel/batch.py.  goofer_tpu vmaps one note's
synthesis over a padded bucket and, across chips, shard_maps it over a
('dp', 'tp') mesh: the note batch rides 'dp', and the mel-knot envelope
decode's contraction axis rides 'tp', closed by a psum.  Here every op
already takes a leading batch axis (engine/synth.py), so ``render_batch``
is one ``_synth_body`` pass, and the mesh versions split rows (and, for
the decode, knot rows) into contiguous shards that devices.py's
``run_on_slots`` issues, each on its slot's device, one worker per
distinct device; results come back in row order on the mesh's first
device.

The tp decode: goofer_tpu's decode is the dense product W @ knots, whose
row for bin i has two non-zero weights, at knots idx[i] and idx[i] + 1
(ops/envelope.py:_decode_taps).  A tp member holding knot rows k0..k1 adds
the taps that fall in its rows and +0 for the others, so a bin's two
products are each added in exactly one member, and the tp sum of the
partials is ``decode_log_env_from_knots`` bit for bit, for any K and
any tp.  The partials are summed in member order on the dp row's first
device (an ordered sum, whether the members are distinct cards or one),
which takes the exp and synthesizes the row once; goofer_tpu repeats the
synthesis on every tp member, with the same outputs.

No batch padding: eager PyTorch takes any shard size, and a dp axis that
does not divide the note batch raises as in goofer_tpu.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from goofer_tpu_torch import config
from goofer_tpu_torch.engine.synth import (
    SYNTH_STREAMS,
    SynthStatic,
    _synth_body,
    default_knobs,
)
from goofer_tpu_torch.ops import noise as rnd
from goofer_tpu_torch.ops.envelope import _decode_taps
from goofer_tpu_torch.devices import run_on_slots, shard_bounds
from goofer_tpu_torch.parallel.mesh import Mesh
from goofer_tpu_torch.sampler.render_core import (
    ARRAY_KEYS,
    device_inputs,
    render_note_core,
)


@dataclass
class NoteBatch:
    """Equal-shape note bucket.  ``lengths`` holds true sample counts;
    features are padded (f0/mask with zeros -> silence, env and tracks
    with edge frames)."""
    env: torch.Tensor       # (B, n_bins, T) or knots (B, K, T)
    f0: torch.Tensor        # (B, N)
    mask: torch.Tensor      # (B, N)
    tracks: torch.Tensor    # (B, 4, T)
    lengths: np.ndarray     # (B,)


def pad_note_batch(envs, f0s, masks, tracks, device=None) -> NoteBatch:
    """Pad per-note features to the bucket maximum, on ``device`` (None:
    config.get_device())."""
    b = len(envs)
    n_max = max(len(f) for f in f0s)
    t_max = max(int(e.shape[1]) for e in envs)
    n_bins = envs[0].shape[0]
    env_b = np.zeros((b, n_bins, t_max), dtype=np.float32)
    f0_b = np.zeros((b, n_max), dtype=np.float32)
    mask_b = np.zeros((b, n_max), dtype=np.float32)
    tr_b = np.zeros((b, 4, t_max), dtype=np.float32)
    lengths = np.zeros(b, dtype=np.int64)
    for i in range(b):
        t = envs[i].shape[1]
        n = len(f0s[i])
        env_b[i, :, :t] = envs[i]
        env_b[i, :, t:] = envs[i][:, -1:]
        f0_b[i, :n] = f0s[i]
        mask_b[i, :n] = masks[i]
        tr_b[i, :, :t] = tracks[i]
        tr_b[i, :, t:] = tracks[i][:, -1:]
        lengths[i] = n
    device = config.get_device(device)
    return NoteBatch(*(torch.as_tensor(a, device=device)
                       for a in (env_b, f0_b, mask_b, tr_b)), lengths)


def _full_knobs(knobs: dict | None, b: int) -> dict:
    """default_knobs() updated by ``knobs``, each broadcast to its (B,) or
    (B, 4) float32 host tensor."""
    full = default_knobs()
    if knobs:
        full.update(knobs)
    out = {}
    for k, v in full.items():
        t = torch.as_tensor(np.asarray(v, dtype=np.float32))
        out[k] = t.expand((b, 4) if k == "formant_band_shifts" else (b,))
    return out


def _synth_rows(st: SynthStatic, env, f0, mask, tracks, knobs: dict,
                keys: np.ndarray, dev):
    """``_synth_body`` over rows already cut to one shard, on ``dev``;
    ``knobs`` are host tensors of those rows, ``keys`` their int64 keys.
    The pitch shift scales f0 first, as goofer_tpu's ``_synth_body``
    does."""
    k = {name: v.to(dev) for name, v in knobs.items()}
    f0 = f0.to(dev, torch.float32) * k.pop("pitch_shift")[:, None]
    return _synth_body(st, env.to(dev), f0, mask.to(dev), tracks.to(dev), k,
                       torch.as_tensor(keys, device=dev))


def _row_keys(seed: int, b: int) -> np.ndarray:
    """(B, SYNTH_STREAMS) keys of rows (seed, 0) .. (seed, B - 1): the
    port's counterpart of ``jax.random.split(key, B)``, the same for a row
    whichever shard renders it."""
    return rnd.stream_keys([(seed, row) for row in range(b)], SYNTH_STREAMS)


def render_batch(st: SynthStatic, batch: NoteBatch, knobs: dict | None = None,
                 seed: int = 0, device=None):
    """Single-device batched render: one synthesis pass over the B rows of
    ``batch`` on ``device`` (None: the batch's).  Returns (mix, harmonic,
    aper_uv, aper_bre), each (B, N)."""
    b = batch.f0.shape[0]
    dev = batch.f0.device if device is None else config.get_device(device)
    return _synth_rows(st, batch.env, batch.f0, batch.mask, batch.tracks,
                       _full_knobs(knobs, b), _row_keys(seed, b), dev)


def tp_partial_log_env(knots: torch.Tensor, k0: int, k: int, sr: int,
                       n_fft: int, n_bins: int) -> torch.Tensor:
    """One tp member's share of the log-envelope W @ knots, (B, n_bins, T)
    float32, from ``knots`` (B, Ks, T): rows k0 .. k0 + Ks - 1 of a K = ``k``
    knot grid.  Each tap of W inside those rows adds its product, exactly
    as ``decode_log_env_from_knots`` rounds it; a tap outside adds +0."""
    idx, w = _decode_taps(sr, n_fft, k)
    idx, w = idx[:n_bins], w[:n_bins]
    dev = knots.device
    ks = knots.shape[-2]
    knots = knots.float()
    total = None
    for tap in (0, 1):
        local = idx + tap - k0
        inside = torch.as_tensor(((local >= 0) & (local < ks))[:, None],
                                 device=dev)
        rows = torch.as_tensor(np.clip(local, 0, ks - 1), device=dev)
        term = (torch.as_tensor(w[:, tap:tap + 1], device=dev)
                * knots.index_select(-2, rows))
        term = torch.where(inside, term, 0.0)
        total = term if total is None else total + term
    return total


def reduce_to(parts: list, dev: torch.device) -> torch.Tensor:
    """The sum of ``parts`` on ``dev``, added in order."""
    total = parts[0].to(dev)
    for p in parts[1:]:
        total = total + p.to(dev)
    return total


def tp_log_env(mesh: Mesh, knots, sr: int, n_fft: int,
               n_bins: int) -> list:
    """The log-envelopes of ``knots`` (B, K, T), rows sharded over 'dp'
    and knot rows over 'tp': each tp member computes its partial
    (tp_partial_log_env) on its own device, and each dp row's partials
    are summed onto the row's first device (reduce_to).  Returns one
    (rows, n_bins, T) float32 tensor per dp row, there; concatenated they
    are decode_log_env_from_knots(knots) bit for bit."""
    knots = torch.as_tensor(knots)
    dp, tp = int(mesh.shape["dp"]), int(mesh.shape["tp"])
    k = knots.shape[1]
    rows = shard_bounds(knots.shape[0], dp)
    slots = mesh.slots

    def member(x, k0, dev):
        return tp_partial_log_env(x.to(dev), k0, k, sr, n_fft, n_bins)

    tasks = [[] for _ in slots]
    for d, (lo, hi) in enumerate(rows):
        for t, (k0, k1) in enumerate(shard_bounds(k, tp)):
            if k1 > k0:
                tasks[d * tp + t].append(partial(
                    member, knots[lo:hi, k0:k1], k0, mesh.devices[d, t]))
    partials = run_on_slots(slots, tasks)

    tasks = [[] for _ in slots]
    for d in range(dp):
        parts = [p for t in range(tp) for p in partials[d * tp + t]]
        tasks[d * tp].append(partial(reduce_to, parts, mesh.devices[d, 0]))
    return [r for done in run_on_slots(slots, tasks) for r in done]


def render_batch_sharded(mesh: Mesh, st: SynthStatic, knots, f0, mask,
                         tracks, knobs: dict | None = None, seed: int = 0,
                         sr=None, n_fft=None, n_bins=None):
    """Multi-device batched render from knot-coded envelopes ``knots``
    (B, K, T) (tensors or arrays; ``f0`` and ``mask`` (B, N), ``tracks``
    (B, 4, T)).  Rows shard over 'dp', knot rows over 'tp' (tp_log_env);
    each dp row's first device takes the exp and synthesizes its rows.
    Row b draws from the key (seed, b), as in ``render_batch``.  Returns
    (mix, harmonic, aper_uv, aper_bre), each (B, N) on the mesh's first
    device."""
    sr = sr or st.sr
    n_fft = n_fft or st.n_fft
    n_bins = n_bins or (n_fft // 2 + 1)
    dp, tp = int(mesh.shape["dp"]), int(mesh.shape["tp"])
    f0, mask, tracks = (torch.as_tensor(a) for a in (f0, mask, tracks))
    b = f0.shape[0]
    if b % dp:
        raise ValueError(
            f"note batch {b} not divisible by the dp mesh axis ({dp}); pad "
            f"the batch (replicate a note and drop its output) or pick a "
            f"dp that divides it")
    logs = tp_log_env(mesh, knots, sr, n_fft, n_bins)
    full = _full_knobs(knobs, b)
    keys = _row_keys(seed, b)
    slots = mesh.slots

    def finish(log_env, lo, hi, dev):
        return _synth_rows(st, torch.exp(log_env), f0[lo:hi], mask[lo:hi],
                           tracks[lo:hi],
                           {n: v[lo:hi] for n, v in full.items()},
                           keys[lo:hi], dev)

    tasks = [[] for _ in slots]
    for d, (lo, hi) in enumerate(shard_bounds(b, dp)):
        tasks[d * tp].append(partial(finish, logs[d], lo, hi,
                                     mesh.devices[d, 0]))
    stems = [r for done in run_on_slots(slots, tasks) for r in done]
    first = slots[0]
    return tuple(torch.cat([s[i].to(first) for s in stems])
                 for i in range(4))


def render_notes_sharded(mesh: Mesh, rs, arrays: list, scalars: list,
                         seeds: list) -> torch.Tensor:
    """One phrase group's whole note render (sampler/render_core.py:
    ``render_note_core``) with its B notes split over every mesh slot, no
    collectives.  ``arrays`` and ``scalars`` hold one dict per note and
    ``seeds`` one seed per note, as for ``render_core.device_inputs``,
    which each shard calls on its own device: an array that is the same
    object for several notes of a shard goes there once.  Returns the
    (B, rs.n) waveforms on the mesh's first device."""
    slots = mesh.slots

    def render(lo, hi, dev):
        tensors, sc, keys = device_inputs(rs, arrays[lo:hi], scalars[lo:hi],
                                          seeds[lo:hi], dev)
        return render_note_core(rs, *(tensors[k] for k in ARRAY_KEYS), sc,
                                keys)

    tasks = [[partial(render, lo, hi, dev)] if hi > lo else []
             for dev, (lo, hi) in zip(slots,
                                      shard_bounds(len(arrays), len(slots)))]
    outs = [r for res in run_on_slots(slots, tasks) for r in res]
    return torch.cat([o.to(slots[0]) for o in outs])
