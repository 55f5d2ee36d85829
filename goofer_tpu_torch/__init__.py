"""goofer_tpu_torch — the PyTorch/CUDA port of goofer_tpu.

A second package beside ``goofer_tpu``: the same singing-voice analysis
and harmonic-plus-noise resynthesis, the UTAU note render (13-argument
CLI -> host planning -> batched note render -> synthesis), the phrase
renderer and the HTTP resampler server, written as plain PyTorch on
tensors, with hand kernels in CUDA C++ for Hopper under ``csrc/``: the
LF pulse pass (``pulse_accumulate.cu``, in place of the JAX package's one
Pallas kernel and the onset-table build before it), the one-pole filter
cascades (``one_pole_cascade.cu``) and, for the analysis, the pitch
Viterbi, the Burg LPC recursion and the LPC root finder.

This package imports ``torch`` and never ``jax`` or ``goofer_tpu``: the
host-side NumPy modules it needs are JAX-free copies, because every
``goofer_tpu`` import first imports JAX.

Library surface (GOOFER.py-compatible, see goofer_tpu_torch.models.hnm
and goofer_tpu_torch.compat):
    extract_features, synthesize, save_features, load_features
CLI surface (SillySampler-compatible): python -m goofer_tpu_torch.cli
(no arguments: the HTTP server on :8572).
"""
from goofer_tpu_torch.config import VERSION as __version__

from goofer_tpu_torch.models.hnm import extract_features, synthesize
from goofer_tpu_torch.io.goofy import (
    save_features,
    load_features,
    formants_to_int_keys,
    pad_trim_to_len,
)

__all__ = [
    "__version__",
    "extract_features",
    "synthesize",
    "save_features",
    "load_features",
    "formants_to_int_keys",
    "pad_trim_to_len",
]
