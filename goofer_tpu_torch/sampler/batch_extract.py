"""Folder-mode batch feature extraction.

Port of goofer_tpu/sampler/batch_extract.py.  The reference parallelizes
over files with a CPU thread pool (ref: SillySampler.py:211-240).  Here
reading and writing run on a host thread pool and the analysis itself is
BATCHED: files group by sample rate and padded length and each chunk of
files runs as one batched pass on the device
(analysis/features.py:extract_features_batch).

A `.goofy` next to the audio file short-circuits the work: the
extract-once cache doubles as the checkpoint/resume story.  A file that
cannot be read is logged and skipped; an error of the analysis itself
(a kernel that does not build or launch) is raised, never worked around.
"""
from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from goofer_tpu_torch.utils.audio_io import is_audio_file, read_wav_mono

log = logging.getLogger("goofer_tpu_torch")


def _feat_path(audio_file: Path) -> Path:
    return audio_file.with_name(f"{audio_file.stem}_features.goofy")


def process_file(audio_file: Path, n_fft: int = 1024, hop: int = 256,
                 device=None) -> bool:
    """Extract + cache features for one file; returns True if work done."""
    from goofer_tpu_torch.analysis.features import extract_features
    from goofer_tpu_torch.io.goofy import save_features

    audio_file = Path(audio_file)
    feat_file = _feat_path(audio_file)
    if feat_file.exists():
        log.info("[SKIP] %s already exists", feat_file.name)
        return False
    log.info("[EXTRACT] %s", audio_file)
    try:
        y, sr = read_wav_mono(audio_file)
    except Exception as e:
        log.error("[ERROR] Failed to read %s: %s", audio_file.name, e)
        return False
    # dense=False: the .goofy keeps knots, not the dense envelope
    _, f0i, vmask, forms, knots = extract_features(
        y, sr, n_fft=n_fft, hop_length=hop, dense=False, device=device)
    save_features(feat_file, knots, f0i, vmask, forms, sr, len(y))
    return True


def extract_features_recursive(input_path, n_fft: int = 1024,
                               hop: int = 256, device=None,
                               mesh=None) -> int:
    """Recursively extract features for every audio file under a path, on
    ``device`` (None: config.get_device()), or split over the slots of
    ``mesh`` (a parallel.mesh.Mesh).  Returns the number of audio files
    found.

    Decode and save run on a thread pool (the reference's only real
    parallelism, ref: SillySampler.py:235-238); analysis runs as
    length-bucketed batched passes on the device (extract_features_batch,
    which shards each chunk over the mesh)."""
    from goofer_tpu_torch import config
    from goofer_tpu_torch.analysis.features import extract_features_batch
    from goofer_tpu_torch.io.goofy import save_features

    if mesh is None:
        device = config.get_device(device)
    input_path = Path(input_path)
    all_files = (input_path.rglob("*") if input_path.is_dir()
                 else [input_path])
    audio_files = sorted(f for f in all_files
                         if f.is_file() and is_audio_file(f))
    todo = []
    for f in audio_files:
        if _feat_path(f).exists():
            log.info("[SKIP] %s already exists", _feat_path(f).name)
        else:
            todo.append(f)
    if not todo:
        log.info("[DONE] Extracted features from %d files.",
                 len(audio_files))
        return len(audio_files)

    workers = max(2, os.cpu_count() or 2)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        def read_one(f):
            try:
                return f, read_wav_mono(f)
            except Exception as e:
                log.error("[ERROR] Failed to read %s: %s", f.name, e)
                return f, None

        decoded = [r for r in pool.map(read_one, todo) if r[1] is not None]

        # group by sample rate; each group batches through the device
        by_sr: dict = {}
        for f, (y, sr) in decoded:
            by_sr.setdefault(int(sr), []).append((f, y))

        writes = []
        for sr, group in by_sr.items():
            for f, _ in group:
                log.info("[EXTRACT] %s", f)
            results = extract_features_batch(
                [y for _, y in group], sr, n_fft=n_fft, hop_length=hop,
                dense=False, device=device, mesh=mesh)
            for (f, y), res in zip(group, results):
                _, f0i, vmask, forms, knots = res
                writes.append(pool.submit(
                    save_features, _feat_path(f), knots, f0i, vmask,
                    forms, sr, len(y)))
        for w in writes:
            w.result()

    log.info("[DONE] Extracted features from %d files.", len(audio_files))
    return len(audio_files)
