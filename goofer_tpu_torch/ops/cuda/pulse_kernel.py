"""Wrapper of the Hopper LF pulse-accumulation kernel.

``csrc/pulse_accumulate.cu`` (which replaces the Pallas TPU kernel
goofer_tpu/ops/pallas/pulse_kernel.py) is compiled by ``nvcc`` into a
shared library with a plain C interface at first use, into
``build/goofer_tpu_torch/`` beside the package, and loaded with
``ctypes``.  The library's name carries a hash of the source and flags,
so an edited source is rebuilt and never served stale.

``pulse_accumulate`` takes the kernel's plain PyTorch version
(ops/pulse.py:accumulate_pulses_plain) only for CPU tensors.  For CUDA
tensors it builds and launches the kernel, or raises: a failed build or
launch never falls back.  ``pulse_accumulate.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "pulse_accumulate.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "goofer_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib = None
_lib_lock = threading.Lock()


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"{SOURCE.name}")


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libpulse_accumulate-{digest}.so"


def build() -> Path:
    """Compile the kernel library unless this source's build exists.
    Returns its path; raises with nvcc's output if compilation fails."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                               f"{SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.goofer_pulse_accumulate
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                           + [ctypes.c_double] * 3
                           + [ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check_inputs(row: torch.Tensor, tables) -> None:
    """Device, dtype, shape and contiguity the kernel takes."""
    dev = row.device
    if dev.type != "cuda":
        raise ValueError(f"pulse_accumulate: tensors on {dev}, expected "
                         "CPU (plain version) or CUDA (kernel)")
    if row.dtype != torch.int32 or row.ndim != 2 or not row.is_contiguous():
        raise ValueError("pulse_accumulate: row must be contiguous (B, n) "
                         f"int32, got {row.dtype} {tuple(row.shape)}")
    for t in tables:
        if (t.device != dev or t.dtype != torch.float32 or t.ndim != 2
                or t.shape[0] != row.shape[0] or not t.is_contiguous()):
            raise ValueError(
                "pulse_accumulate: tables must be contiguous (B, M) float32 "
                f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if len({t.shape[1] for t in tables}) != 1:
        raise ValueError("pulse_accumulate: tables differ in length")


def pulse_accumulate(row: torch.Tensor, pos_tab: torch.Tensor,
                     t0_tab: torch.Tensor, t_tab: torch.Tensor,
                     norm_tab: torch.Tensor, Ra: float, Rg: float,
                     Rk: float, guard: bool,
                     max_overlap: int) -> torch.Tensor:
    """Sum of the K = ``max_overlap`` most recent peak-normalized LF pulses
    per sample; (B, n) float32.  See ops/pulse.py for the tables."""
    tables = (pos_tab, t0_tab, t_tab, norm_tab)
    if row.device.type == "cpu" and all(t.device.type == "cpu"
                                        for t in tables):
        from goofer_tpu_torch.ops.pulse import accumulate_pulses_plain

        return accumulate_pulses_plain(row, *tables, Ra, Rg, Rk, guard,
                                       max_overlap)
    _check_inputs(row, tables)
    lib = _load()
    batch, n = row.shape
    out = torch.empty((batch, n), dtype=torch.float32, device=row.device)
    with torch.cuda.device(row.device):
        stream = torch.cuda.current_stream(row.device).cuda_stream
        err = lib.goofer_pulse_accumulate(
            row.data_ptr(), pos_tab.data_ptr(), t0_tab.data_ptr(),
            t_tab.data_ptr(), norm_tab.data_ptr(), out.data_ptr(),
            batch, n, pos_tab.shape[1], int(max_overlap),
            float(Ra), float(Rg), float(Rk), int(bool(guard)), stream)
    if err != 0:
        raise RuntimeError(f"pulse_accumulate kernel launch failed: CUDA "
                           f"error {err}")
    pulse_accumulate.launches += 1
    return out


pulse_accumulate.launches = 0
