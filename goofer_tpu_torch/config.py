"""Global configuration for goofer_tpu_torch.

Constants mirror goofer_tpu/config.py (all compute float32).  Importing
this module pins float32 matrix products and convolutions to full
float32 on the card: TF32 keeps ~3 decimal digits, which the LSD parity
budgets against the JAX package cannot absorb.
"""
from __future__ import annotations

import os

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Compute dtype for all device math (ref: GOOFER.py:8).
COMPUTE_DTYPE = np.float32
# Storage dtype for .goofy feature files (ref: GOOFER.py:7).
STORAGE_DTYPE = np.float16

# Frame parameters used by the resampler CLI (ref: SillySampler.py:14-15).
SAMPLER_N_FFT = 1024
SAMPLER_HOP = SAMPLER_N_FFT // 4

# Engine self-test defaults (ref: GOOFER.py:1262-1263).
ENGINE_N_FFT = 2048
ENGINE_HOP = ENGINE_N_FFT // 4

# Voicing threshold: f0 above this many Hz counts as voiced
# (ref: GOOFER.py:941-943, 966).
VOICING_THRESHOLD_HZ = 75.0

# f0 clipping range applied after per-sample interpolation
# (ref: GOOFER.py:964).
F0_CLIP_LO = 1e-5
F0_CLIP_HI = 2000.0

# LF glottal model constants used by the main pulse train
# (ref: GOOFER.py:1074 call site).
PULSE_RA = 0.02
PULSE_RG = 1.7
PULSE_RK = 0.8

# Period clamp for the pulse-train generator, in samples
# (ref: GOOFER.py:496-499).
PULSE_T0_MIN = 3
PULSE_T0_MAX = 8192

# Default bound on simultaneously overlapping pulse generations summed per
# output sample; the resampler derives a tighter one per note.
PULSE_MAX_OVERLAP = 16

# Fallback f0 used by the pulse train before the first voiced sample
# (ref: GOOFER.py:481).
PULSE_FALLBACK_F0 = 160.0

# HTTP server port for the resampler server mode (ref: SillySampler.py:1220).
SERVER_PORT = 8572

VERSION = "0.1.1"
# Version string of the reference CLI surface we reproduce
# (ref: SillySampler.py:1226).
REFERENCE_CLI_VERSION = "v2.6.1"

# Pulse-overlap buckets (K): the resampler rounds its per-note bound up
# to one of these, exactly as goofer_tpu does, so both packages sum the
# same number of pulse generations.
PULSE_OVERLAP_BUCKETS = (8, 16, 32)


def bucket_overlap(k: int) -> int:
    """Round a pulse-overlap bound up to a bucket."""
    for b in PULSE_OVERLAP_BUCKETS:
        if k <= b:
            return b
    return PULSE_OVERLAP_BUCKETS[-1]


# Assumed minimum pulse-onset spacing (samples): sizes the compact onset
# tables (M = n / spacing rows).  Smaller is always safe.
PULSE_MIN_SPACING = 16
PULSE_MIN_SPACING_BUCKETS = (8, 16, 32, 64, 128, 256)


def bucket_min_spacing(s: int) -> int:
    """Round an onset-spacing bound DOWN to a bucket; bounds below 8
    clamp to 8."""
    out = PULSE_MIN_SPACING_BUCKETS[0]
    for b in PULSE_MIN_SPACING_BUCKETS:
        if b <= s:
            out = b
    return out


def bucket_len(n: int, base: int = 4096, ratio: float = 1.5,
               quantum: int = 1024) -> int:
    """Round a sample count up to a geometric length bucket (~ratio step,
    quantized), so notes of nearby lengths share one batched pass.
    Padding costs only masked device work: the phrase renderer slices
    outputs back to their true extents on the device."""
    b = base
    while b < n:
        b = -(-int(b * ratio) // quantum) * quantum
    return b


def bucket_frames(n_bucket: int, hop: int) -> int:
    """Envelope-frame bucket derived from a sample bucket: covers any true
    frame count a note of <= n_bucket samples can produce (+margin), so a
    (sample bucket, frame bucket) pair never splits a group."""
    return n_bucket // hop + 8


def bucket_batch(b: int) -> int:
    """Round a note-batch size up to a bucket (1, 2, 3, 4, 6, 8, then
    steps of ~1.25x).  Eager PyTorch takes any batch size, so the phrase
    renderer does not pad its batches; this is kept for static-shape
    replay (CUDA graphs)."""
    b = int(b)
    p = 1 << max(0, b.bit_length() - 2)
    cands = {p, 2 * p, 3 * p, 4 * p, 6 * p, 8 * p}
    if p >= 8:
        cands.update({(5 * p) // 4, (5 * p) // 2, 5 * p})
    for cand in sorted(cands):
        if cand >= b:
            return cand
    return 8 * p


DEVICE_ENV = "GOOFER_TPU_TORCH_DEVICE"


def get_device(spec: str | torch.device | None = None) -> torch.device:
    """The device a render runs on.

    ``spec`` None reads ``$GOOFER_TPU_TORCH_DEVICE`` and defaults to
    ``cuda``.  Asking for CUDA on a machine without it raises: the port
    never falls back to the CPU on its own.  ``cpu`` must be asked for
    explicitly and runs every kernel's plain PyTorch version."""
    if spec is None:
        spec = os.environ.get(DEVICE_ENV, "cuda")
    dev = torch.device(spec)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {spec!r} requested but CUDA is not available; set "
            f"{DEVICE_ENV}=cpu to run the plain PyTorch versions")
    return dev
