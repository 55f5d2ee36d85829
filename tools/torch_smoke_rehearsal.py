#!/usr/bin/env python3
"""Rehearse chip_smoke.py's editor, codec and parallel phases on the CPU.

    python3 tools/torch_smoke_rehearsal.py

Runs ``build_codecs``, ``editor_slice``, ``codec_slice`` and
``parallel_slice`` (phrases cut to 12 notes, 12 files, 1 timed run) of
chip_smoke.py with ``dev="cpu"``: the kernels' plain versions stand in,
each call of one counted as its kernel's launch, so that the phases'
launch checks, file checks and int16 comparisons run before a chip call.
The parallel phase's meshes repeat the CPU; its M1 and M2 are printed as
not built (no card).
``torch.cuda.synchronize`` becomes a no-op, and the codecs are built
afresh into a temporary directory, so that their build is timed.  The
times it prints are host times on the CPU, never device numbers.
"""
from __future__ import annotations

import shutil
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from goofer_tpu_torch.ops.cuda import (  # noqa: E402
    _build,
    burg_kernel,
    cascade_kernel,
    lpc_roots_kernel,
    pulse_kernel,
    viterbi_kernel,
)

WRAPPERS = ((pulse_kernel, "pulse_accumulate"),
            (cascade_kernel, "one_pole_cascade"),
            (viterbi_kernel, "pitch_viterbi"),
            (lpc_roots_kernel, "lpc_roots"),
            (burg_kernel, "burg_lpc"))
counted_by_name: dict = {}


def count_plain_calls() -> None:
    """Replace each kernel wrapper, wherever it was imported, by one that
    counts its calls on ``.launches`` as the wrapper counts launches."""
    for module, name in WRAPPERS:
        real = getattr(module, name)

        def counted(*args, _real=real, **kwargs):
            out = _real(*args, **kwargs)
            _build.count_launch(counted_by_name[_real.__name__])
            return out

        counted.launches = 0
        counted_by_name[real.__name__] = counted
        for mod in list(sys.modules.values()):
            if mod is not None and getattr(mod, name, None) is real:
                setattr(mod, name, counted)


def main() -> int:
    torch.cuda.synchronize = lambda *args: None
    count_plain_calls()
    with tempfile.TemporaryDirectory() as tmp:
        _build.BUILD_DIR = Path(tmp) / "build"
        _, seconds = chip_smoke.build_codecs()
        print(f"codec build (g++, both at once): {seconds:.2f} s")
        chip_smoke.editor_slice(Path(tmp), dev="cpu")
        chip_smoke.codec_slice(Path(tmp), dev="cpu")
        for ext in (".wav", "_features.goofy"):
            shutil.copy(chip_smoke.REPO / "tests" / "golden" / "voice"
                        / f"src{ext}", Path(tmp) / f"voice{ext}")
        chip_smoke.parallel_slice(Path(tmp), dev="cpu", notes=12, files=12,
                                  reps=1, mesh_reps=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
