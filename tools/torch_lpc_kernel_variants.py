#!/usr/bin/env python3
"""Build, check and time layout variants of the two LPC kernels of
goofer_tpu_torch (csrc/lpc_roots.cu, csrc/burg_lpc.cu) on one card.

    python3 tools/torch_lpc_kernel_variants.py [--parent DIR]

Root finder: the kept source (several rows per warp, 4 warps per CTA),
the same with 8 warps per CTA, and one thread per row with every root in
registers (tools/lpc_roots_thread_per_row.cu, order 10 only).  Burg: the
kept source (a warp per frame, 4 per CTA), with 2 or 8 warps per CTA, and
with every frame's stretches in shared memory instead of registers.  With
``--parent DIR``, a checkout of an earlier commit, its two sources join as
variants ``parent``.  Each variant is compiled by nvcc into
build/lpc_variants/ (the range of ptxas's registers over the source's
kernels, and its spills, printed), held to the
plain version on chip_smoke.py's LPC cases with chip_smoke.py's limits,
and timed as chip_smoke.py times kernels (device ms per launch, 100
launches behind a spin), in turns: every variant, then every variant
again in reverse order.  Prints the card first, then one line per
variant and case.  Imports nothing of JAX or goofer_tpu.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from goofer_tpu_torch.analysis import formants  # noqa: E402
from goofer_tpu_torch.ops.cuda import (  # noqa: E402
    _build,
    burg_kernel,
    lpc_roots_kernel,
)

OUT = REPO / "build" / "lpc_variants"
ROOTS_SRC = lpc_roots_kernel.KERNEL.source
BURG_SRC = burg_kernel.KERNEL.source

# name: (source, edits)
ROOTS_VARIANTS = {
    "packed_w4": (ROOTS_SRC, []),
    "packed_w8": (ROOTS_SRC, [("constexpr int kWarps = 4;",
                               "constexpr int kWarps = 8;")]),
    "thread_per_row": (REPO / "tools" / "lpc_roots_thread_per_row.cu", []),
}
BURG_VARIANTS = {
    "warp_w4": (BURG_SRC, []),
    "warp_w2": (BURG_SRC, [("constexpr int kWarps = 4;",
                            "constexpr int kWarps = 2;")]),
    "warp_w8": (BURG_SRC, [("constexpr int kWarps = 4;",
                            "constexpr int kWarps = 8;")]),
    "warp_w4_shared": (BURG_SRC, [("constexpr int kMaxRegStretch = 36;",
                                   "constexpr int kMaxRegStretch = 0;")]),
}


def build(name: str, source: Path, edits) -> tuple[Path, str]:
    """Compile one variant; returns its library and ptxas's report."""
    src = source.read_text()
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
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", proc.stderr)]
    spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill",
                                            proc.stderr))
    return so, (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
                f"{spills} bytes spilled")


def use(kernel, so: Path) -> None:
    """Point a wrapper's Kernel at a variant's library."""
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, kernel.symbol)
    fn.argtypes = kernel.argtypes
    fn.restype = ctypes.c_int
    kernel._lib = lib


def check_roots(name, a, known):
    got = lpc_roots_kernel.lpc_roots(a)
    want = formants.poly_roots_dk_plain(a)
    torch.cuda.synchronize()
    if not torch.equal(torch.isnan(torch.view_as_real(got)),
                       torch.isnan(torch.view_as_real(want))):
        raise AssertionError(f"{name}: NaN pattern differs")
    conv = formants.converged_roots(a, want).all(dim=1)
    err = float(cs.matched_root_error(got[conv], want[conv]).max())
    if not err <= cs.ROOTS_TOL:
        raise AssertionError(f"{name}: matched roots differ by {err}")
    if known is not None:
        truth = torch.as_tensor(known, device=a.device).to(torch.complex64)
        k_err = float(cs.matched_root_error(got[conv], truth[conv]).max())
        if not k_err <= 1e-3:
            raise AssertionError(f"{name}: known roots missed by {k_err}")
    return err


def check_burg(name, frames):
    got = burg_kernel.burg_lpc(frames, cs.LPC_ORDER)
    want = formants.burg_coeffs_plain(frames, cs.LPC_ORDER)
    torch.cuda.synchronize()
    if not torch.allclose(got, want, rtol=cs.BURG_RTOL, atol=cs.BURG_ATOL):
        raise AssertionError(f"{name}: max |diff| "
                             f"{float((got - want).abs().max())}")
    return float((got - want).abs().max())


def run(kernel, variants: dict, libs: dict, cases, check, call) -> None:
    """Check every variant on every case, then time them in turns."""
    order = list(variants)
    times = {(v, c): [] for v in order for c in cases}
    errs = {}
    for v in order:
        use(kernel, libs[v])
        for c, args in cases.items():
            errs[v, c] = check(f"{v} {c}", *args)
    for v in order + order[::-1]:
        use(kernel, libs[v])
        for c, args in cases.items():
            times[v, c].append(cs.cuda_ms(lambda: call(args[0])))
    for v in order:
        for c in cases:
            t = times[v, c]
            print(f"{kernel.name} {v} {c}: max|diff|={errs[v, c]:.3e} "
                  f"ms {t[0]:.5f} / {t[1]:.5f}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", type=Path, default=None)
    args = parser.parse_args()
    print(cs.card_line(), flush=True)
    roots_v, burg_v = dict(ROOTS_VARIANTS), dict(BURG_VARIANTS)
    if args.parent is not None:
        csrc = args.parent / "goofer_tpu_torch" / "csrc"
        roots_v["parent"] = (csrc / "lpc_roots.cu", [])
        burg_v["parent"] = (csrc / "burg_lpc.cu", [])
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {("roots", k): v for k, v in roots_v.items()}
    jobs.update({("burg", k): v for k, v in burg_v.items()})
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(
            lambda kv: build(f"{kv[0][0]}_{kv[0][1]}", *kv[1]),
            jobs.items())))
    for (kind, name), (_, report) in built.items():
        print(f"ptxas {kind} {name}: {report}", flush=True)

    dev = torch.device("cuda")
    lpc = cs.lpc_cases(dev)
    frames = {name: (f,) for name, f, _, _ in lpc if f is not None}
    polys = {name: (given if f is None
                    else formants.burg_coeffs_plain(f, cs.LPC_ORDER), known)
             for name, f, given, known in lpc}
    run(burg_kernel.KERNEL, burg_v,
        {k: built["burg", k][0] for k in burg_v}, frames, check_burg,
        lambda f: burg_kernel.burg_lpc(f, cs.LPC_ORDER))
    run(lpc_roots_kernel.KERNEL, roots_v,
        {k: built["roots", k][0] for k in roots_v}, polys, check_roots,
        lpc_roots_kernel.lpc_roots)
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
