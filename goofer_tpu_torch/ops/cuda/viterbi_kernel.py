"""Wrapper of the Hopper pitch-Viterbi kernel.

``csrc/pitch_viterbi.cu`` solves the pitch tracker's max-sum path over K
voiced candidates + 1 unvoiced state per frame for a whole batch of files
in one launch, one CTA per row: one warp walks the chain of frames while
the others compute the transition costs a tile ahead (it replaces
goofer_tpu/analysis/pitch.py:_viterbi, non-Pallas JAX code: two
associative scans of max-plus matrices), and is built at first use by
ops/cuda/_build.py.  The kernel's step is unrolled for the tracker's K =
``CANDIDATES`` = 6 (``PitchConfig.max_candidates``, which nothing in the
port changes); the wrapper raises for any other K on the card.
``SHARED_BACK_BYTES`` mirrors the source's constant: a row's backpointers,
frames x (K + 1) bytes, stay in shared memory up to that size and go to a
global scratch beyond it.

``pitch_viterbi`` takes the plain PyTorch version
(analysis/pitch.py:viterbi_plain) only for CPU tensors.  For CUDA tensors
it builds and launches the kernel, or raises: a failed build or launch
never falls back.  ``pitch_viterbi.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from goofer_tpu_torch.ops.cuda._build import Kernel, count_launch

CANDIDATES = 6
SHARED_BACK_BYTES = 32 * 1024

KERNEL = Kernel(
    "pitch_viterbi", "goofer_pitch_viterbi",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
    + [ctypes.c_void_p])


def _check_inputs(freqs, strengths, unvoiced, nf) -> None:
    """Device, dtype, shape and contiguity the kernel takes."""
    if freqs.device.type != "cuda":
        raise ValueError(f"pitch_viterbi: tensors on {freqs.device}, "
                         "expected CPU (plain version) or CUDA (kernel)")
    for name, t, dtype in (("freqs", freqs, torch.float32),
                           ("strengths", strengths, torch.float32),
                           ("unvoiced_strength", unvoiced, torch.float32),
                           ("nf", nf, torch.int32)):
        if (t.device != freqs.device or t.dtype != dtype
                or not t.is_contiguous()):
            raise ValueError(
                f"pitch_viterbi: {name} must be contiguous {dtype} on "
                f"{freqs.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}{'' if t.is_contiguous() else ' (non-contiguous)'}")
    if (freqs.ndim != 3 or strengths.shape != freqs.shape
            or unvoiced.shape != freqs.shape[:2]
            or nf.shape != freqs.shape[:1]):
        raise ValueError(
            "pitch_viterbi: freqs and strengths must be (B, F, K), "
            "unvoiced_strength (B, F) and nf (B,), got "
            f"{tuple(freqs.shape)}, {tuple(strengths.shape)}, "
            f"{tuple(unvoiced.shape)} and {tuple(nf.shape)}")
    if freqs.shape[2] != CANDIDATES:
        raise ValueError(f"pitch_viterbi: K = {freqs.shape[2]} candidates, "
                         f"the kernel takes {CANDIDATES}")
    if freqs.shape[1] * (CANDIDATES + 1) > 2**31 - 1:
        raise ValueError(f"pitch_viterbi: rows of {freqs.shape[1]} frames "
                         "overflow the kernel's int indices")


def pitch_viterbi(freqs: torch.Tensor, strengths: torch.Tensor,
                  unvoiced_strength: torch.Tensor, nf: torch.Tensor,
                  vu_cost: float, oj_cost: float):
    """The best path through (B, F, K) float32 candidates ``freqs`` with
    ``strengths`` and the (B, F) ``unvoiced_strength``; row b stops at
    frame ``nf[b]`` ((B,) int32).  Returns (f0 (B, F) float32, 0 where
    unvoiced and past nf; path (B, F) state indices, K for unvoiced, -1
    past nf; int32 from the kernel, int64 from the plain version); see
    analysis/pitch.py:viterbi_plain."""
    if all(t.device.type == "cpu"
           for t in (freqs, strengths, unvoiced_strength, nf)):
        from goofer_tpu_torch.analysis.pitch import viterbi_plain

        return viterbi_plain(freqs, strengths, unvoiced_strength, nf,
                             vu_cost, oj_cost)
    _check_inputs(freqs, strengths, unvoiced_strength, nf)
    launch = KERNEL.function()
    batch, frames, k = freqs.shape
    dev = freqs.device
    f0 = torch.empty((batch, frames), dtype=torch.float32, device=dev)
    path = torch.empty((batch, frames), dtype=torch.int32, device=dev)
    back = None
    if frames * (k + 1) > SHARED_BACK_BYTES:
        back = torch.empty((batch, frames, k + 1), dtype=torch.uint8,
                           device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(freqs.data_ptr(), strengths.data_ptr(),
                     unvoiced_strength.data_ptr(), nf.data_ptr(),
                     None if back is None else back.data_ptr(),
                     f0.data_ptr(), path.data_ptr(), batch, frames, k,
                     float(vu_cost), float(oj_cost), stream)
    if err != 0:
        raise RuntimeError(f"pitch_viterbi kernel launch failed: CUDA "
                           f"error {err}")
    count_launch(pitch_viterbi)
    return f0, path


pitch_viterbi.launches = 0
