"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface at first use, into
``build/goofer_tpu_torch/`` beside the package, and loaded with
``ctypes``.  A library's name carries a hash of its source and flags, so
an edited source is rebuilt and never served stale.
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

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "goofer_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels in goofer_tpu_torch/csrc")


class Kernel:
    """One ``csrc/<name>.cu`` library: ``build()`` compiles it unless this
    source's build exists; ``load()`` opens it once per process and
    declares ``symbol``'s C signature."""

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self._lib = None
        self._lock = threading.Lock()

    @property
    def source(self) -> Path:
        return CSRC / f"{self.name}.cu"

    def library_path(self) -> Path:
        digest = hashlib.sha256(
            self.source.read_bytes()
            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}-{digest}.so"

    def build(self) -> Path:
        """Returns the library's path; raises with nvcc's output if
        compilation fails."""
        out = self.library_path()
        if out.exists():
            return out
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(self.source)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {self.source}:\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return out

    def function(self):
        """The loaded C entry point, building the library if needed."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._lib = lib
            return getattr(self._lib, self.symbol)


def build_all(kernels) -> list[Path]:
    """Build several kernels at once, one nvcc process each."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max(1, len(kernels))) as pool:
        return list(pool.map(lambda k: k.build(), kernels))
