"""ctypes bindings of the native parallel parser (``fastio.cpp``), built with
g++ at first use.

Counterpart of ``sparsebase_tpu/io/fastio/__init__.py`` (reference:
src/sparsebase/external/pigo/pigo.hpp + io/pigo_*_reader.cc): mmap and
OpenMP chunked parsing in C++. The library is built from this package's
own copy of the source into ``sparsebase_tpu_torch/_build/`` (keyed by the
source's hash; ``_build.build_host``). If g++ is missing or refuses the
source, the compiler's output is logged and ``available()`` is False, so
that callers take their numpy routes, as in the JAX package.

Arrays cross as CPU tensors: ids int64, values float64.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

_SRC = Path(__file__).resolve().parent / "fastio.cpp"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False

_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)
LINE_BYTES = 72  # the longest body line sbtpu_format_mtx writes


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    sigs = {
        "sbtpu_count_entries": [ctypes.c_char_p, ctypes.c_int64],
        "sbtpu_parse_entries": [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64, _I64P, _I64P, _F64P],
        "sbtpu_parse_values": [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, _F64P],
        "sbtpu_sort_packed": [ctypes.c_int64, _I64P, _I64P],
        "sbtpu_sort_packed_weighted": [ctypes.c_int64, _I64P, _I64P, _F64P],
        "sbtpu_argsort_pairs": [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, _I64P],
        "sbtpu_format_mtx": [ctypes.c_int64, _I64P, _I64P, ctypes.c_int64, ctypes.c_int, _I64P, _F64P,
                             ctypes.c_void_p, ctypes.c_int64],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int64
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is None and not _build_failed:
            from ..._build import KernelBuildError, build_host
            from ...utils.logger import Logger

            try:
                _lib = _bind(ctypes.CDLL(str(build_host(_SRC))))
            except (KernelBuildError, OSError) as e:
                _build_failed = True
                Logger("fastio").warning(f"native build failed; the numpy routes stay in use:\n{str(e)[:2000]}")
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(t: Optional[torch.Tensor], ptype=_I64P):
    return None if t is None else ctypes.cast(t.data_ptr(), ptype)


def count_entries(path: str, offset: int) -> int:
    n = _load().sbtpu_count_entries(path.encode(), offset)
    if n < 0:
        raise OSError(f"fastio: cannot read {path}")
    return int(n)


def parse_entries(path: str, offset: int, weighted: bool, out=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Parse ``u v [w]`` lines after byte ``offset``: ``(rows, cols, vals)``
    as int64, int64 and float64 CPU tensors (``vals`` None unweighted).
    ``out=(rows, cols, vals)`` reuses the caller's buffers (sliced to the
    parsed count): a warm buffer spares the first-touch page faults of a
    fresh one."""
    lib = _load()
    n = count_entries(path, offset)
    if out is not None:
        if len(out[0]) < n or len(out[1]) < n or (weighted and len(out[2]) < n):
            raise ValueError(f"fastio: out buffers smaller than {n} entries")
        rows, cols, vals = out[0][:n], out[1][:n], out[2][:n] if weighted else None
    else:
        rows = torch.empty(n, dtype=torch.int64)
        cols = torch.empty(n, dtype=torch.int64)
        vals = torch.empty(n, dtype=torch.float64) if weighted else None
    got = lib.sbtpu_parse_entries(path.encode(), offset, 3 if weighted else 2, n, _ptr(rows), _ptr(cols),
                                  _ptr(vals, _F64P))
    if got < 0:
        raise OSError(f"fastio: cannot read {path}")
    return rows[:got], cols[:got], None if vals is None else vals[:got]


def parse_values(path: str, offset: int) -> torch.Tensor:
    """One number per line after byte ``offset`` (the array format's body),
    as float64."""
    n = count_entries(path, offset)
    vals = torch.empty(n, dtype=torch.float64)
    got = _load().sbtpu_parse_values(path.encode(), offset, n, _ptr(vals, _F64P))
    if got < 0:
        raise OSError(f"fastio: cannot read {path}")
    return vals[:got]


def _int64_copy(t) -> torch.Tensor:
    return torch.as_tensor(t).to(dtype=torch.int64, device="cpu", copy=True).contiguous()


def sort_pairs_inplace(major, minor) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """Row-major sort of a pattern pair list as packed 64-bit keys: sorted
    int64 copies, or None when the library is missing or an id is outside
    [0, 2^32)."""
    lib = _load()
    if lib is None:
        return None
    mj, mn = _int64_copy(major), _int64_copy(minor)
    return (mj, mn) if lib.sbtpu_sort_packed(len(mj), _ptr(mj), _ptr(mn)) == 1 else None


def sort_pairs_weighted_inplace(major, minor, vals):
    """Row-major sort of a weighted entry list, the float64 value riding the
    packed key: sorted (int64, int64, float64) copies, or None (library
    missing, or an id outside [0, 2^32)). The order among duplicate
    coordinates is unspecified."""
    lib = _load()
    if lib is None:
        return None
    mj, mn = _int64_copy(major), _int64_copy(minor)
    vv = torch.as_tensor(vals).to(dtype=torch.float64, device="cpu", copy=True).contiguous()
    ok = lib.sbtpu_sort_packed_weighted(len(mj), _ptr(mj), _ptr(mn), _ptr(vv, _F64P))
    return (mj, mn, vv) if ok == 1 else None


def argsort_pairs(major: torch.Tensor, minor: torch.Tensor) -> Optional[torch.Tensor]:
    """Parallel stable argsort by (major, minor), int64; None when the
    library is missing or a key is not int32 or int64."""
    lib = _load()
    if lib is None or major.dtype not in (torch.int32, torch.int64) or minor.dtype not in (torch.int32, torch.int64):
        return None
    major, minor = major.cpu().contiguous(), minor.cpu().contiguous()
    n = len(major)
    order = torch.empty(n, dtype=torch.int64)
    got = lib.sbtpu_argsort_pairs(n, major.data_ptr(), minor.data_ptr(), int(major.dtype == torch.int64),
                                  int(minor.dtype == torch.int64), _ptr(order))
    return order if got == n else None


def format_mtx(rows: Optional[torch.Tensor], cols: Optional[torch.Tensor], base: int,
               ivals: Optional[torch.Tensor] = None, dvals: Optional[torch.Tensor] = None,
               buf: Optional[np.ndarray] = None) -> memoryview:
    """MatrixMarket body lines, as the Python writer formats them: ``r c``
    (ids plus ``base``), then ``int(v)`` of int64 ``ivals`` or ``repr(v)``
    of float64 ``dvals``; with ``rows`` None the value alone. Every tensor
    is a contiguous CPU tensor of one length. The lines land in ``buf`` (a
    uint8 array of at least ``LINE_BYTES`` per line, reused across calls)
    or in a new array; the view returned is valid until ``buf`` is reused."""
    n = len(dvals if dvals is not None else ivals if ivals is not None else rows)
    kind = 2 if dvals is not None else 1 if ivals is not None else 0
    if buf is None or len(buf) < n * LINE_BYTES:
        buf = np.empty(n * LINE_BYTES, dtype=np.uint8)
    got = _load().sbtpu_format_mtx(n, _ptr(rows), _ptr(cols), base, kind, _ptr(ivals), _ptr(dvals, _F64P),
                                   buf.ctypes.data, len(buf))
    if got < 0:
        raise OSError("fastio: MTX body lines overran their buffer")
    return memoryview(buf)[:got]
