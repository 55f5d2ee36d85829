"""The port's DSP layer: plain PyTorch on (B, ...) tensors, with the
hand kernels' wrappers under ``ops.cuda`` (each built at its first
launch, never on import).

Import submodules directly (``from goofer_tpu_torch.ops import stft``
would shadow the module with its same-named function, so no function
re-exports live here).
"""
from goofer_tpu_torch.ops import (  # noqa: F401
    envelope,
    filters,
    interp,
    jitter,
    pulse,
    scan_iir,
    stft,
    windows,
)
