"""goofer_tpu_torch — the PyTorch/CUDA port of goofer_tpu.

A second package beside ``goofer_tpu``: the same UTAU note render
(13-argument CLI -> host planning -> fused note render -> harmonic-plus-
noise synthesis) written as plain PyTorch on tensors, with the one
Pallas kernel of the JAX package (the LF pulse accumulation) rewritten by
hand in CUDA C++ for Hopper (``csrc/pulse_accumulate.cu``).

This package imports ``torch`` and never ``jax`` or ``goofer_tpu``: the
host-side NumPy modules it needs are JAX-free copies, because every
``goofer_tpu`` import first imports JAX.

CLI surface: ``python -m goofer_tpu_torch.cli in.wav out.wav ...`` (the
13-argument render mode, from a cached ``.goofy``).
"""
from goofer_tpu_torch.config import VERSION as __version__

__all__ = ["__version__"]
