"""Phrase renderer: batched multi-note rendering through the full flag
pipeline.

Port of goofer_tpu/sampler/phrase.py.  The reference renders one note per
process; a whole phrase is N sequential renders.  Here notes are planned
on the host, grouped by their render signature (RenderStatic + array
shapes), and each group runs as ONE batched pass of the complete render
(sampler/render_core.py:render_note_core), the notes on the batch axis of
every op: one launch of the pulse kernel per pulse pass and one of the
cascade kernel per cascade per group, not per note.  Notes in a group
differ freely in pitch curve, mix levels, shift ratios and every other
scalar.

What goofer_tpu needs here for XLA and the port does not: the cache of
jitted vmapped graphs and its budget, the ahead-of-time export, the
compile thread pool, and the padding of the batch size to a bucket
(eager PyTorch takes any batch size; config.bucket_batch stays for
static-shape replay).  Length buckets are kept, for another reason than
bounding compiles: without them a phrase of 40 distinct note lengths is
40 batches of one note.

With a mesh (parallel/mesh.py), each group's notes split into contiguous
shards over the mesh's slots, each shard one batched pass on its slot's
device, issued by devices.run_on_slots (one worker per distinct device);
a note keeps its noise key (seed, note index) whichever shard renders it.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, replace
from functools import partial
from pathlib import Path

import numpy as np
import torch

from goofer_tpu_torch import config
from goofer_tpu_torch.devices import run_on_slots, shard_bounds, synchronize
from goofer_tpu_torch.io.goofy import formants_to_int_keys
from goofer_tpu_torch.sampler.render_core import (
    ARRAY_KEYS as ARRAY_ORDER,
    device_inputs,
    render_note_core,
)
from goofer_tpu_torch.sampler.resampler import (
    GooferResampler,
    _bucketize,
    acquire_features,
)
from goofer_tpu_torch.utils.audio_io import write_wav
from goofer_tpu_torch.utils.profiling import count, entry, span, traced


@dataclass
class NoteSpec:
    """One note of a phrase: the UTAU args minus the output path."""
    in_file: str
    pitch: str
    velocity: float = 100
    flags: str = ""
    offset: float = 0
    length: float = 1000
    consonant: float = 0
    cutoff: float = 0
    volume: float = 100
    modulation: float = 0
    tempo: str = "!120"
    pitch_string: str = "AA"


@dataclass
class _Planned:
    index: int
    rs: object
    arrays: dict
    scalars: dict


# Shared by every thread that plans phrases, so every get/insert (and the
# clear-when-full sweep) happens under a lock; readers keep their own
# reference to the hit, so a concurrent clear cannot take an entry away
# mid-use.
_cache_lock = threading.Lock()
_plan_memo: dict = {}
PLAN_MEMO_LIMIT = 4096

# When a phrase has more distinct note geometries than this, 'auto'
# bucketing kicks in: padded-length buckets trade masked device work for
# fewer, larger batches.  Phrases of repeating geometry (the common
# quantized-UST case) keep exact shapes and zero padding.
AUTO_BUCKET_GEOMETRIES = 4


def _shape_key(pl: _Planned) -> tuple:
    return tuple(np.asarray(pl.arrays[k]).shape for k in ARRAY_ORDER)


# statics that only size the pulse kernel's tables and its lookback:
# grouping ignores them and each group harmonizes to its most conservative
# member, so a melody spanning octaves shares batches.  Pulse spacings
# harmonize to the MIN (smaller is always safe: it only grows the onset
# table); pulse-overlap bounds harmonize to the MAX (a deeper lookback only
# visits rows whose pulses have ended: output-identical).
_SPACING_FIELDS = ("min_spacing", "growl_min_spacing",
                   "subharm_min_spacing", "su_min_spacing")
_OVERLAP_FIELDS = ("max_overlap", "growl_max_overlap")


def _spacing_neutral(rs):
    return replace(rs,
                   **{f: config.PULSE_MIN_SPACING for f in _SPACING_FIELDS},
                   **{f: config.PULSE_MAX_OVERLAP for f in _OVERLAP_FIELDS})


def group_planned(planned) -> dict:
    """Group planned notes by (render signature, array shapes), ignoring
    the pulse-bound statics, then harmonize each group's bounds to its
    most conservative member.  Returns {(rs, shape_key): [planned...]}
    where rs is the harmonized RenderStatic to render the group with."""
    groups: dict = {}
    for pl in planned:
        groups.setdefault((_spacing_neutral(pl.rs), _shape_key(pl)),
                          []).append(pl)
    return {
        (replace(key_rs,
                 **{f: min(getattr(m.rs, f) for m in members)
                    for f in _SPACING_FIELDS},
                 **{f: max(getattr(m.rs, f) for m in members)
                    for f in _OVERLAP_FIELDS}), sk): members
        for (key_rs, sk), members in groups.items()
    }


@traced("plan.phrase", notes=lambda notes, *a, **k: len(notes))
def plan_phrase(notes, n_fft: int = config.SAMPLER_N_FFT,
                hop: int = config.SAMPLER_HOP,
                bucket: bool | str = "auto", device=None):
    """Host-plan every note (features acquired once per source file, cut
    slices / looped tracks / pitch curves memoized across notes).
    Returns (planned, feature_cache).

    ``bucket=True`` pads note geometry to shared length buckets so a
    phrase of arbitrary note lengths renders as a handful of batches
    (resampler._bucketize); ``"auto"`` (default) buckets only when the
    phrase has more than AUTO_BUCKET_GEOMETRIES distinct geometries.
    ``device`` is where a knot-coded envelope is decoded, as for
    GooferResampler.

    Spans ``plan.features`` (int keys and reversed copies of a source's
    features), ``plan.memo``, ``plan.flags``, ``plan.prepare`` and
    ``plan.bucket``; counters ``plan.notes`` and ``plan.memo.hit`` /
    ``.miss`` / ``.clear``."""
    device = config.get_device(device)
    count("plan.notes", len(notes))
    feature_cache: dict = {}
    prep_cache: dict = {}
    planned = []
    for i, spec in enumerate(notes):
        if spec.in_file not in feature_cache:
            feats = acquire_features(Path(spec.in_file), n_fft, hop, device)
            with span("plan.features"):
                env, f0i, vmask, forms, sr, ylen = feats
                forms_c = formants_to_int_keys(forms)
                rev = (env[:, ::-1], f0i[::-1], vmask[::-1],
                       {k: np.asarray(forms_c[k])[::-1] for k in forms_c})
                feature_cache[spec.in_file] = (feats, forms_c, rev)
        feats, forms_c, rev = feature_cache[spec.in_file]
        env, f0i, vmask, forms, sr, ylen = feats
        # cross-call plan memo: keyed on the note spec + the IDENTITY of
        # the memoized feature tuple (an edited .goofy reloads as a new
        # object, so stale plans cannot be served).  Repeat renders of the
        # same notes skip the flag decode and the cut/loop/pitch planning;
        # arrays stay the SAME objects, so arrays shared by a group still
        # go to the device once.
        with span("plan.memo"):
            mkey = (id(feats), spec.pitch, spec.velocity, spec.flags,
                    spec.offset, spec.length, spec.consonant, spec.cutoff,
                    spec.volume, spec.modulation, spec.tempo,
                    spec.pitch_string, n_fft, hop)
            with _cache_lock:
                hit = _plan_memo.get(mkey)
                count("plan.memo.miss" if hit is None else "plan.memo.hit")
        if hit is None:
            r = GooferResampler(
                spec.in_file, "/dev/null", spec.pitch, spec.velocity,
                spec.flags, spec.offset, spec.length, spec.consonant,
                spec.cutoff, spec.volume, spec.modulation, spec.tempo,
                spec.pitch_string, n_fft=n_fft, hop=hop, device=device,
                autorender=False)
            if r.params.reverse:
                env_use, f0_use, mask_use, forms_use = rev
            else:
                env_use, f0_use, mask_use, forms_use = (env, f0i, vmask,
                                                        forms_c)
            rs, arrays, scalars = r.prepare(env_use, f0_use, mask_use,
                                            forms_use, sr, ylen,
                                            cache=prep_cache)
            # pin feats so its id() stays unique while the entry lives
            hit = (rs, arrays, scalars, feats)
            with span("plan.memo"), _cache_lock:
                if len(_plan_memo) > PLAN_MEMO_LIMIT:
                    _plan_memo.clear()
                    count("plan.memo.clear")
                _plan_memo[mkey] = hit
        planned.append(_Planned(i, hit[0], hit[1], hit[2]))

    with span("plan.bucket", notes=len(planned)):
        if bucket == "auto":
            bucket = len({(_spacing_neutral(pl.rs), _shape_key(pl))
                          for pl in planned}) > AUTO_BUCKET_GEOMETRIES
        if bucket:
            for pl in planned:
                pl.rs, pl.arrays = _bucketize(pl.rs, pl.arrays, prep_cache)
    return planned, feature_cache


def _true_len(pl: _Planned, rs) -> int:
    return int(pl.scalars.get("n_true") or rs.n)


@traced("phrase.group", notes=lambda rs, members, *a, **k: len(members))
def render_group(rs, members, seed: int, pcm16: bool, device) -> torch.Tensor:
    """One group as one batched pass on ``device``: (B, max true length)
    float32, or int16 PCM with ``pcm16``.  Note ``m`` draws its noise
    from the key (seed, m.index) whatever group it is in."""
    tensors, sc, keys = device_inputs(
        rs, [m.arrays for m in members], [m.scalars for m in members],
        [(seed, m.index) for m in members], device)
    out = render_note_core(rs, *(tensors[k] for k in ARRAY_ORDER), sc, keys)
    # padded tail columns are cut on the device, before any copy
    out = out[:, :max(_true_len(m, rs) for m in members)]
    if pcm16:
        q = torch.clamp(out, -1.0, 32767.0 / 32768.0) * 32768.0
        out = torch.round(q).to(torch.int16)
    return out


@entry(notes=lambda notes, *a, **k: len(notes))
def render_phrase(notes, n_fft: int = config.SAMPLER_N_FFT,
                  hop: int = config.SAMPLER_HOP, seed: int = 0,
                  pcm16: bool = False, bucket: bool | str = "auto",
                  fetch: bool = True, device=None, mesh=None):
    """Render a list of NoteSpec; returns the list of waveforms (NumPy,
    each of its note's true length) in the input order.  Notes sharing a
    render signature go through the render as one batch; every group is
    issued before any result is fetched, and results are copied into
    pinned host memory without blocking, so copies overlap the groups
    still running.

    ``bucket`` (default "auto", see plan_phrase) pads note geometry to
    shared buckets, so that phrases of arbitrary note lengths still
    render in a handful of batches; outputs are cut back to true extents
    on the device before the copy.

    ``pcm16=True`` quantizes to int16 PCM on the device (the payload of
    the output WAVs), halving the copy.

    ``fetch=False`` is a benchmarking hook: wait until every group's
    result is ready on the device, skip the copy to the host and return
    None.

    ``device`` None picks config.get_device() (CUDA unless
    $GOOFER_TPU_TORCH_DEVICE says otherwise).  ``mesh`` (a
    parallel.mesh.Mesh, not together with ``device``) splits every
    group's notes over the mesh's slots; planning decodes knot envelopes
    on its first device.

    One ``request``; spans ``phrase.groups`` (grouping), ``phrase.group``
    per pass, ``render.fetch`` (the copies' issue, then the host arrays)
    and ``render.wait``."""
    if mesh is not None and device is not None:
        raise ValueError("render_phrase: pass device= or mesh=, not both")
    slots = (mesh.slots if mesh is not None
             else [config.get_device(device)])
    planned, _ = plan_phrase(notes, n_fft, hop, bucket=bucket,
                             device=slots[0])
    outs: list = [None] * len(planned)

    def issue(rs, members, dev):
        result = render_group(rs, members, seed, pcm16, dev)
        if fetch and dev.type == "cuda":
            with span("render.fetch", notes=len(members)):
                host = torch.empty(result.shape, dtype=result.dtype,
                                   pin_memory=True)
                host.copy_(result, non_blocking=True)
            result = host
        return rs, members, result

    tasks = [[] for _ in slots]
    with span("phrase.groups", notes=len(planned)):
        for (rs, _), members in group_planned(planned).items():
            for i, (lo, hi) in enumerate(shard_bounds(len(members),
                                                      len(slots))):
                if hi > lo:
                    tasks[i].append(partial(issue, rs, members[lo:hi],
                                            slots[i]))
    pending = [p for done in run_on_slots(slots, tasks) for p in done]

    with span("render.wait", notes=len(planned)):
        synchronize(slots)
    if not fetch:
        return None
    with span("render.fetch", notes=len(planned)):
        for rs, members, result in pending:
            result = result.numpy()
            for j, m in enumerate(members):
                outs[m.index] = result[j, :_true_len(m, rs)]
    return outs


@entry(notes=lambda notes, *a, **k: len(notes))
def render_phrase_to_wavs(notes, out_paths, **kw):
    """Render and write one WAV per note (batch offline rendering), each
    at its source's sample rate: one ``request``."""
    outs = render_phrase(notes, **kw)
    mesh = kw.get("mesh")
    device = (mesh.slots[0] if mesh is not None
              else config.get_device(kw.get("device")))
    n_fft = kw.get("n_fft", config.SAMPLER_N_FFT)
    hop = kw.get("hop", config.SAMPLER_HOP)
    for spec, wave, path in zip(notes, outs, out_paths):
        # memoized by the render's own planning
        sr = acquire_features(Path(spec.in_file), n_fft, hop, device)[4]
        write_wav(path, wave, sr)
    return outs
