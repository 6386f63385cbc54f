"""Builds the hand-written CUDA kernels in ``csrc/`` and binds them; builds
the host C++ libraries (``io/fastio``, ``native``) the same way with g++.

The kernels are compiled at first use, from this package's sources only,
by ``nvcc`` for Hopper (``sm_90a``): one ``nvcc -c`` per source, all
started together, then one link into a shared library with a plain C
interface, loaded with ``ctypes``. The library lands in ``_build/<hash>/``,
where the hash covers the sources and the flags: an edited source
rebuilds, an unchanged one loads what is there. A failed build raises
with the compiler's output attached.

Each C entry point launches on the stream it is given, allocates nothing,
does not synchronise, and returns ``cudaGetLastError()``. A :class:`Kernel`
raises on a non-zero return and counts its successful launches, so a run
can show that its path went through the kernel.

The host libraries (:func:`build_host`) are one ``g++`` call each, keyed by
the hash of their source and flags, built under a file lock to a temporary
name and moved into place, so that concurrent processes build once and
never load a half-written library.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .utils.tracing import count, counters, reset_counters

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = (
    "banded_spmv.cu", "csr_spmv.cu", "indptr.cu", "radix_sort.cu", "relocate.cu", "common_neighbors.cu", "label_prop.cu",
    "errors.cu",
)
LIB_NAME = "libsbtorch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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


def nvcc_commands(nvcc: str, out: Path) -> Tuple[List[List[str]], List[str]]:
    """One compile per source, to an object file beside ``out``, and the
    link of those objects into the shared library ``out``."""
    objs = [out.with_name(f"{out.name}.{Path(s).stem}.o") for s in SOURCES]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)] for s, o in zip(SOURCES, objs)]
    return compiles, [nvcc, "-shared", "-o", str(out), *map(str, objs)]


def _run_all(cmds: List[List[str]]) -> List[Tuple[List[str], int, str]]:
    """Runs the commands at once; ``(cmd, returncode, output)`` for each.
    Every process started is waited for, or killed on the way out."""
    procs = []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=BUILD_TIMEOUT_S)[0] for p in procs]
        return [(cmd, p.returncode, out) for cmd, p, out in zip(cmds, procs, outs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def build() -> Path:
    """Path of the kernel library, compiling it first if this exact source
    set has not been built yet."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    compiles, link = nvcc_commands(find_nvcc(), tmp)
    try:
        runs = _run_all(compiles)
        if all(rc == 0 for _, rc, _ in runs):
            runs += _run_all([link])
    finally:
        for obj in out_dir.glob(f"{tmp.name}.*.o"):
            obj.unlink()
    log = "".join(" ".join(cmd) + "\n" + out for cmd, _, out in runs)
    (out_dir / "build.log").write_text(log)
    failed = [rc for _, rc, _ in runs if rc != 0]
    if failed:
        raise KernelBuildError(f"nvcc exited with {failed[0]}:\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


HOST_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-std=c++17")


def build_host(source: Path, timeout_s: float = 300) -> Path:
    """Path of the shared library built from the one C++ ``source`` with
    ``g++`` (``HOST_FLAGS``), compiling it first if this source and these
    flags have not been built yet. Raises :class:`KernelBuildError` with the
    compiler's output when g++ is missing or refuses the source."""
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    h.update(source.read_bytes())
    out_dir = BUILD_ROOT / f"{source.stem}-{h.hexdigest()[:16]}"
    lib = out_dir / f"lib{source.stem}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the process ends, however it ends
        if lib.exists():  # another process built it while this one waited
            return lib
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise KernelBuildError("g++ not found on PATH")
        tmp = out_dir / f"{lib.name}.{os.getpid()}.tmp"
        cmd = [cxx, *HOST_FLAGS, str(source), "-o", str(tmp)]
        try:
            run = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s)
        except subprocess.TimeoutExpired as e:
            raise KernelBuildError(f"{' '.join(cmd)} took over {timeout_s} s") from e
        if run.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelBuildError(f"g++ exited with {run.returncode}:\n{' '.join(cmd)}\n{run.stderr}")
        os.replace(tmp, lib)
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
    """One C entry point of the library; each launch counts under
    ``launch:<name>`` in ``utils.tracing``'s counters."""

    def __init__(self, name: str, symbol: str, argtypes):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
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
        count(f"launch:{self.name}")


KERNELS: Dict[str, Kernel] = {}


def reset_launch_counts() -> None:
    reset_counters("launch:")


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last reset, from the counters."""
    seen = counters()
    return {name: seen.get(f"launch:{name}", 0) for name in KERNELS}
