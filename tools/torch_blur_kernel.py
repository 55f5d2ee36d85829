#!/usr/bin/env python3
"""Build csrc/gaussian_blur.cu, print what ptxas reports for it
(registers, shared memory, spills), hold it to its plain PyTorch version
on chip_smoke.py's blur cases (with each case's time, bound and
F.conv1d's time), and time the rows kernel at every outputs-per-lane
choice of ``blur_kernel.RUNS`` and the bin-axis kernel at both of its
runs, each held bit-equal to the layout the wrapper picks.  With
``--parent DIR`` it also builds DIR's
goofer_tpu_torch/csrc/gaussian_blur.cu (the first layout's C interface)
and times it on the same inputs, in turns with this tree's kernel
(parent, change, change, parent):

    python3 tools/torch_blur_kernel.py [--parent build/parent]

(``git archive <commit> goofer_tpu_torch/csrc | tar -x -C build/parent``
makes DIR.)  Needs one CUDA device and nvcc; prints the card's name and
power limit first.  Exits nonzero if the kernel does not build, launch or
agree.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from goofer_tpu_torch.ops import filters  # noqa: E402
from goofer_tpu_torch.ops.cuda import _build, blur_kernel  # noqa: E402


def ptxas_report(source: Path) -> str:
    """ptxas -v's lines for one source (compiled to a scratch file)."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / "k.so"), str(source)],
            capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    return "\n".join(line for line in proc.stderr.splitlines()
                     if "registers" in line or "spill" in line
                     or "Compiling" in line)


def parent_blur(parent: Path, out_dir: Path):
    """The parent's blur (the first C interface: no layout arguments) as a
    function of (x, taps, axis) on CUDA tensors."""
    lib_path = out_dir / "libgaussian_blur_parent.so"
    source = parent / "goofer_tpu_torch" / "csrc" / "gaussian_blur.cu"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                    str(lib_path), str(source)], check=True)
    fn = ctypes.CDLL(str(lib_path)).goofer_gaussian_blur
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def blur(x, taps, axis):
        axis = axis % x.ndim
        w = blur_kernel._taps_on(x.device, taps.tobytes())
        out = torch.empty_like(x)
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                 math.prod(x.shape[:axis]), x.shape[axis],
                 math.prod(x.shape[axis + 1:]), len(taps),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent blur: CUDA error {err}")
        return out

    return blur


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 1
    print(cs.card_line())
    print(ptxas_report(blur_kernel.KERNEL.source))
    t0 = time.perf_counter()
    _build.build_all([blur_kernel.KERNEL])
    print(f"build: {time.perf_counter() - t0:.2f} s")
    cases = cs.blur_cases()
    cs.check_blur_kernel(cases)

    dev = torch.device("cuda")
    results = {}
    for name, x_np, sigma, axis in cases:
        if x_np.ndim != 2:
            continue
        x = torch.as_tensor(x_np, device=dev)
        taps = filters.gaussian_kernel1d(sigma)
        batch, n = x.shape
        picked = blur_kernel.rows_geometry(batch, n, len(taps))
        want = blur_kernel.launch_blur(x, taps)
        row = {"picked": picked.run, "ctas": batch * picked.tiles,
               "parts": picked.parts}
        for run in blur_kernel.RUNS:
            got = blur_kernel.launch_blur(x, taps, run=run)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: run {run} changes the bits")
            geo = blur_kernel.rows_geometry(batch, n, len(taps), run)
            row[f"run{run}_ms"] = cs.cuda_ms(
                lambda: blur_kernel.launch_blur(x, taps, run=run))
            row[f"run{run}_ctas"] = batch * geo.tiles
        results[name] = row
        print(f"rows layout {name}: {json.dumps(row)}")

    for name, x_np, sigma, axis in cases:
        if x_np.ndim == 2:
            continue
        x = torch.as_tensor(x_np, device=dev)
        taps = filters.gaussian_kernel1d(sigma)
        moved = torch.movedim(x, axis, -1)
        outer = math.prod(x.shape[:axis % x.ndim])
        inner = moved[..., 0].numel() // outer
        picked = blur_kernel.col_run(outer, x.shape[axis], inner, len(taps))
        want = blur_kernel.launch_blur(x, taps, axis)
        row = {"picked": picked}
        for run in sorted({picked, blur_kernel.COL_RUN_SMALL,
                           blur_kernel.COL_RUN_SHORT if len(taps) <= 17
                           else blur_kernel.COL_RUN}):
            if not torch.equal(blur_kernel.launch_blur(x, taps, axis, run),
                               want):
                raise AssertionError(f"{name}: run {run} changes the bits")
            row[f"run{run}_ms"] = cs.cuda_ms(
                lambda: blur_kernel.launch_blur(x, taps, axis, run))
        print(f"cols layout {name}: {json.dumps(row)}")

    # the complex blur: one launch of the float view vs the parts apart,
    # for a spectrum stored bins by frames and one stored as an STFT's
    rng = np.random.default_rng(5)
    planes = [torch.as_tensor(rng.standard_normal(
        (cs.BLUR_BATCH, 130, 513)).astype(np.float32), device=dev)
        for _ in range(2)]
    for stored, S in (("bins by frames", torch.complex(*planes).mT
                       .contiguous()),
                      ("frames by bins (STFT)", torch.complex(*planes).mT)):

        def two_launches():
            return torch.complex(
                filters.gaussian_blur1d(S.real.contiguous(), 0.5, axis=-2),
                filters.gaussian_blur1d(S.imag.contiguous(), 0.5, axis=-2))

        one = filters.gaussian_blur_complex_freq(S, 0.5)
        if not torch.equal(one, two_launches()):
            raise AssertionError(f"complex blur {stored}: one launch "
                                 "differs from two")
        one_ms = cs.cuda_ms(lambda: filters.gaussian_blur_complex_freq(
            S, 0.5))
        print(f"complex blur (80, 513, 130) stored {stored}: one launch "
              f"{one_ms:.5f} ms, two launches with the copies and "
              f"torch.complex {cs.cuda_ms(two_launches):.5f} ms")

    if args.parent:
        with tempfile.TemporaryDirectory() as tmp:
            parent = parent_blur(args.parent, Path(tmp))
            for name, x_np, sigma, axis in cases:
                if x_np.ndim == 4:
                    continue
                x = torch.as_tensor(x_np, device=dev)
                taps = filters.gaussian_kernel1d(sigma)
                ms = {}
                for tag, fn in (("parent", parent), ("change",
                                blur_kernel.launch_blur),
                                ("change", blur_kernel.launch_blur),
                                ("parent", parent)):
                    ms.setdefault(tag, []).append(
                        cs.cuda_ms(lambda: fn(x, taps, axis)))
                print(f"parent vs change {name}: parent "
                      f"{ms['parent']} ms, change {ms['change']} ms")
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
