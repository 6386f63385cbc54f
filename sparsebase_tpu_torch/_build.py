"""Builds the hand-written CUDA kernels in ``csrc/`` and binds them.

The kernels are compiled at first use, from this package's sources only,
by ``nvcc`` for Hopper (``sm_90a``) into one shared library with a plain C
interface, loaded with ``ctypes``. The library lands in ``_build/<hash>/``,
where the hash covers the sources and the flags: an edited source
rebuilds, an unchanged one loads what is there. A failed build raises
with the compiler's output attached.

Each C entry point launches on the stream it is given, allocates nothing,
does not synchronise, and returns ``cudaGetLastError()``. A :class:`Kernel`
raises on a non-zero return and counts its successful launches, so a run
can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("banded_spmv.cu", "csr_spmv.cu", "indptr.cu", "radix_sort.cu", "relocate.cu", "errors.cu")
LIB_NAME = "libsbtorch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / spills per kernel, kept in build.log
)
BUILD_TIMEOUT_S = 900


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for cand in candidates:
        if cand and os.path.isfile(cand):
            return cand
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def nvcc_command(nvcc: str, out: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *(str(CSRC / s) for s in SOURCES)]


def build() -> Path:
    """Path of the kernel library, compiling it first if this exact source
    set has not been built yet."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = nvcc_command(find_nvcc(), tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    (out_dir / "build.log").write_text(log)
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc exited with {proc.returncode}:\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


_LIBRARY: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIBRARY
    if _LIBRARY is None:
        lib = ctypes.CDLL(str(build()))
        lib.sb_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sb_cuda_error_string.restype = ctypes.c_char_p
        _LIBRARY = lib
    return _LIBRARY


class Kernel:
    """One C entry point of the library, with its launch count."""

    def __init__(self, name: str, symbol: str, argtypes):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        KERNELS[name] = self

    def launch(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = library().sb_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.name}: CUDA launch failed: error {err} ({msg})")
        self.launches += 1


KERNELS: Dict[str, Kernel] = {}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}
