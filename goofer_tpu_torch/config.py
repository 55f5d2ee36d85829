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

# Frame parameters used by the resampler CLI (ref: SillySampler.py:14-15).
SAMPLER_N_FFT = 1024
SAMPLER_HOP = SAMPLER_N_FFT // 4

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
