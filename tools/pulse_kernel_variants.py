#!/usr/bin/env python3
"""Build and time layout variants of the pulse-pass kernel on one card.

    python3 tools/pulse_kernel_variants.py

Each variant is goofer_tpu_torch/csrc/pulse_accumulate.cu with one edit:
the cluster size, threads per CTA and samples per thread (the same
65536-sample tile; 16-CTA clusters need the non-portable size), the
float64 phase step as a plain division, or no accumulation (the scans and
the table alone, timed but not checked).  All are compiled by nvcc at
once into build/pulse_variants/, checked against the plain version (ops/pulse.py:pulse_pass_plain) and
timed as chip_smoke.py times kernels (device ms per launch, 100 launches
behind a spin) on a silent row, glide_gap (n = 40000, K = 8) and the
longest note at the heavy note's main-layer K = 32 and spacing 64.  Prints
the card, then one line per variant and case.  Imports nothing of JAX or
goofer_tpu.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from goofer_tpu_torch.ops import pulse  # noqa: E402
from goofer_tpu_torch.ops.cuda import _build, pulse_kernel  # noqa: E402

OUT = REPO / "build" / "pulse_variants"
LAUNCH = "  const cudaError_t err = cudaLaunchKernelEx("
NON_PORTABLE = ("  cudaFuncSetAttribute(pulse_accumulate_kernel, "
                "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n")


def layout(cluster: int, threads: int, run: int):
    return [("constexpr int kCluster = 8;",
             f"constexpr int kCluster = {cluster};"),
            ("constexpr int kThreads = 1024;",
             f"constexpr int kThreads = {threads};"),
            ("constexpr int kRun = 8;", f"constexpr int kRun = {run};"),
            (LAUNCH, NON_PORTABLE + LAUNCH)]


# name: (edits, checked against the plain version)
VARIANTS = {
    "c8_1024x8": ([], True),
    "c8_1024x8_div": ([("return fma(fma(-q0, sr, a), inv_sr, q0);",
                        "return a / sr;")], True),
    # no accumulation: the scans and the table alone, timed only
    "c8_1024x8_noacc": ([("j >= max(0, r - max_overlap + 1); --j) {",
                          "j >= max(0, r + 1); --j) {")], False),
    "c16_1024x4": (layout(16, 1024, 4), True),
    "c16_512x8": (layout(16, 512, 8), True),
}


def build(name: str, edits) -> Path:
    src = pulse_kernel.KERNEL.source.read_text()
    for old, new in edits:
        if old not in src:
            raise AssertionError(f"variant {name}: {old!r} not in source")
        src = src.replace(old, new)
    cu = OUT / f"{name}.cu"
    cu.write_text(src)
    so = OUT / f"lib{name}.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                           "-v", "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    regs = [ln.strip() for ln in proc.stderr.splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"variant {name}: {' | '.join(regs)}", flush=True)
    return so


def load(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    lib.goofer_pulse_accumulate.argtypes = pulse_kernel.KERNEL.argtypes
    return lib


def launcher(lib):
    def run(f0, gate, sr, scale, fallback, ra, rg, rk, guard, k, spacing):
        batch, n = f0.shape
        m = pulse_kernel.table_rows(n, spacing)
        table = torch.empty((batch, m, 4), device=f0.device)
        out = torch.empty_like(f0)
        err = lib.goofer_pulse_accumulate(
            f0.data_ptr(), None if gate is None else gate.data_ptr(),
            table.data_ptr(), out.data_ptr(), batch, n, m, k, sr, scale,
            fallback, ra, rg, rk, int(guard),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out
    return run


def cases():
    by_name = {c[0]: c for c in chip_smoke._pulse_cases()}
    out = []
    for name, k, spacing in (("silence", None, None),
                             ("glide_gap", None, None),
                             (f"glide_{chip_smoke.N_LONG}", 32, 64)):
        _, f0, gate = by_name[name]
        args = chip_smoke.pulse_pass_args(f0, gate is not None)
        if k is not None:
            args = args[:-2] + (k, spacing)
            name = f"{name}_K{k}_s{spacing}"
        out.append((name, f0, gate, args))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("pulse_kernel_variants: CUDA is not available", file=sys.stderr)
        return 1
    print(chip_smoke.card_line())
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(lambda kv: build(kv[0], kv[1][0]),
                              VARIANTS.items()))
    libs = {name: load(so) for name, so in zip(VARIANTS, built)}
    dev = torch.device("cuda")
    for name, f0_np, gate_np, args in cases():
        f0 = torch.as_tensor(f0_np, device=dev)
        gate = None if gate_np is None else torch.as_tensor(gate_np,
                                                            device=dev)
        want = pulse.pulse_pass_plain(f0, gate, *args)
        torch.cuda.synchronize()
        for variant, lib in libs.items():
            run = launcher(lib)
            got = run(f0, gate, *args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ms = chip_smoke.cuda_ms(lambda: run(f0, gate, *args))
            print(f"{name} {variant}: max|diff| {err:.3e} kernel {ms:.5f} ms",
                  flush=True)
            if VARIANTS[variant][1] and not err <= chip_smoke.PULSE_TOL:
                raise AssertionError(f"{variant} {name}: max |diff| {err}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
