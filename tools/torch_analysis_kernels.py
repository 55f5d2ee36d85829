#!/usr/bin/env python3
"""Build the three analysis kernels of goofer_tpu_torch (pitch Viterbi,
LPC roots, Burg), print what ptxas reports for each (registers, shared
memory, spills), and hold each to its plain PyTorch version on the card
with chip_smoke.py's cases and limits.  The short first run after an edit
to one of the sources:

    python3 tools/torch_analysis_kernels.py

Needs one CUDA device and nvcc; prints the card's name and power limit
first.  Exits nonzero if a kernel does not build, launch or agree.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from goofer_tpu_torch.ops.cuda import _build  # noqa: E402

KERNELS = (cs.viterbi_kernel.KERNEL, cs.lpc_roots_kernel.KERNEL,
           cs.burg_kernel.KERNEL)


def ptxas_report(kernel) -> str:
    """ptxas -v's lines for one source (compiled to a scratch file)."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / "k.so"), str(kernel.source)],
            capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {kernel.source}:\n{proc.stderr}")
    return "\n".join(line for line in proc.stderr.splitlines()
                     if "registers" in line or "spill" in line
                     or "Compiling" in line)


def main() -> int:
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    print(cs.card_line())
    for k in KERNELS:
        print(f"--- {k.name}\n{ptxas_report(k)}")
    t0 = time.perf_counter()
    _build.build_all(list(KERNELS))
    print(f"build: {time.perf_counter() - t0:.2f} s")
    dev = torch.device("cuda")
    cs.check_viterbi_kernel(cs.viterbi_cases(dev))
    cases = cs.lpc_cases(dev)
    _, coeffs, _ = cs.check_burg_kernel(cases)
    cs.check_lpc_roots_kernel(cases, coeffs)
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
