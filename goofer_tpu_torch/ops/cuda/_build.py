"""Build and load the port's native libraries.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface at first use, into ``BUILD_DIR``,
and loaded with ``ctypes``; the host C++ audio codecs (``csrc/*.cpp``, see
goofer_tpu_torch.native) are built the same way by ``g++``.  A library's
name carries a hash of its source and flags, so an edited source is
rebuilt and never served stale.

``BUILD_DIR`` is ``build/goofer_tpu_torch/`` of a source checkout (a
``pyproject.toml`` beside the package; the repository's ``.gitignore``
lists ``build/``), and ``${XDG_CACHE_HOME:-~/.cache}/goofer_tpu_torch``
for an installed package, whose own directory may be read-only.
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


def default_build_dir() -> Path:
    """Where this copy of the package builds its libraries."""
    root = Path(__file__).resolve().parents[3]
    if (root / "pyproject.toml").is_file():
        return root / "build" / "goofer_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "goofer_tpu_torch"


BUILD_DIR = default_build_dir()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# one lock for every wrapper's launch counter: the mesh path launches
# from one worker thread per card, and ``+= 1`` is a read-modify-write
# that can lose a count between threads
_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` under a lock.  Reads and resets
    stay plain attribute accesses (``wrapper.launches = 0``)."""
    with _count_lock:
        wrapper.launches += 1


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


def library_path(source: Path, flags) -> Path:
    """``BUILD_DIR/lib<stem>-<hash of source and flags>.so``."""
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build_library(source: Path, flags, find_compiler) -> Path:
    """Compile ``source`` with ``find_compiler()`` and ``flags`` unless its
    build exists; returns the library's path.  The library is written
    through a temporary file and ``os.replace``, so that concurrent
    builders never load a half-written one; raises with the compiler's
    output if compilation fails."""
    out = library_path(source, flags)
    if out.exists():
        return out
    from goofer_tpu_torch.utils.profiling import count

    compiler = find_compiler()
    count("setup.kernel_build")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([compiler, *flags, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{Path(compiler).name} failed ({proc.returncode}) on "
                f"{source}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


class Kernel:
    """One ``csrc/<name>.cu`` library: ``build()`` compiles it unless this
    source's build exists; ``function()`` opens it once per process (the
    span ``setup.kernel_load``, recorded whether spans are on or not) and
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

    def build(self) -> Path:
        """Returns the library's path; raises with nvcc's output if
        compilation fails."""
        return build_library(self.source, NVCC_FLAGS, find_nvcc)

    def function(self):
        """The loaded C entry point, building the library if needed."""
        with self._lock:
            if self._lib is None:
                from goofer_tpu_torch.utils.profiling import span

                with span("setup.kernel_load", always=True):
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
