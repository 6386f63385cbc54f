"""ctypes bindings of the native host graph algorithms (``graphkit.cpp``),
built with g++ at first use.

Counterpart of ``sparsebase_tpu/native/__init__.py``: SlashBurn, RCM,
Rabbit, AMD, nested dissection, PuLP and k-way partitioning, Jaccard,
triangles and fill-in in C++17 (reference: src/sparsebase/reorder/*.cc,
partition/*.cc), each the exact mirror of the JAX package's numpy route.
The library is built from this package's own copy of the source into
``sparsebase_tpu_torch/_build/`` (``_build.build_host``). If g++ is missing
or refuses it, the compiler's output is logged and ``available()`` is
False; ``config.use_graphkit=False`` turns the library off as well.

The bindings take CSR arrays as CPU tensors (any integer type, widened to
int64; a tensor on the card raises ``TypeError``) and return CPU tensors.
"""

from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path
from typing import Optional

import torch

_SRC = Path(__file__).resolve().parent / "graphkit.cpp"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False

_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)
_F32P = ctypes.POINTER(ctypes.c_float)
_I64, _F64, _INT = ctypes.c_int64, ctypes.c_double, ctypes.c_int

_SIGNATURES = {
    "sbtpu_slashburn": [_I64, _I64P, _I64P, _I64, _INT, _INT, _I64P],
    "sbtpu_rcm": [_I64, _I64, _I64P, _I64P, _I64P],
    "sbtpu_rabbit": [_I64, _I64P, _I64P, _I64P],
    "sbtpu_amd": [_I64, _I64P, _I64P, _F64, _I64, _I64P],
    "sbtpu_partition_kway": [_I64, _I64P, _I64P, _F64P, _I64, _I64, _I64, _I64, _I64P],
    "sbtpu_nested_dissection": [_I64, _I64P, _I64P, _I64, _I64, _I64, _I64, _I64P],
    "sbtpu_pulp": [_I64, _I64P, _I64P, _I64P, _I64, _I64, _F64, _I64, _I64P],
    "sbtpu_jaccard": [_I64, _I64P, _I64P, _F32P],
    "sbtpu_triangles": [_I64, _I64P, _I64P, _INT, _I64P],
    "sbtpu_fill_in": [_I64, _I64P, _I64P, _I64P],
}


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is None and not _build_failed:
            from .._build import KernelBuildError, build_host
            from ..utils.logger import Logger

            try:
                lib = ctypes.CDLL(str(build_host(_SRC)))
            except (KernelBuildError, OSError) as e:
                _build_failed = True
                Logger("graphkit").warning(f"native build failed; the torch routes stay in use:\n{str(e)[:2000]}")
                return None
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int64
            _lib = lib
        return _lib


def available() -> bool:
    """True when the library loads and ``config.use_graphkit`` is on."""
    from ..config import get_config

    return get_config().use_graphkit and _load() is not None


def _host(t, dtype: torch.dtype) -> torch.Tensor:
    """``t`` as a contiguous CPU tensor of ``dtype``; a tensor on another
    device raises: the caller copies it to the host (``csr.to_host()``)."""
    if isinstance(t, torch.Tensor) and t.device.type != "cpu":
        raise TypeError(f"graphkit takes CPU tensors, got one on {t.device}")
    return torch.as_tensor(t).to(dtype=dtype).contiguous()


def _i64(t) -> torch.Tensor:
    return _host(t, torch.int64)


def _p(t: Optional[torch.Tensor], ptype=_I64P):
    return None if t is None else ctypes.cast(t.data_ptr(), ptype)


def _call(name: str, *args) -> None:
    if getattr(_load(), name)(*args) != 0:
        raise RuntimeError(f"graphkit {name[len('sbtpu_'):]} failed")


def slashburn(n, indptr, indices, k_size, greedy, hub_order) -> torch.Tensor:
    ip, ix, out = _i64(indptr), _i64(indices), torch.empty(n, dtype=torch.int64)
    _call("sbtpu_slashburn", n, _p(ip), _p(ix), int(k_size), int(bool(greedy)), int(bool(hub_order)), _p(out))
    return out


def rcm(nrows, ncols, indptr, indices) -> torch.Tensor:
    """RCM order over ``max(nrows, ncols)`` vertices; the library folds and
    symmetrizes the pattern itself."""
    ip, ix, out = _i64(indptr), _i64(indices), torch.empty(max(nrows, ncols), dtype=torch.int64)
    _call("sbtpu_rcm", nrows, ncols, _p(ip), _p(ix), _p(out))
    return out


def rabbit(n, indptr, indices) -> torch.Tensor:
    ip, ix, out = _i64(indptr), _i64(indices), torch.empty(n, dtype=torch.int64)
    _call("sbtpu_rabbit", n, _p(ip), _p(ix), _p(out))
    return out


def amd(n, indptr, indices, dense_threshold, aggressive=True) -> torch.Tensor:
    ip, ix, out = _i64(indptr), _i64(indices), torch.empty(n, dtype=torch.int64)
    thr = float(dense_threshold) if math.isfinite(dense_threshold) else 1e300
    _call("sbtpu_amd", n, _p(ip), _p(ix), thr, int(bool(aggressive)), _p(out))
    return out


def nested_dissection(n, indptr, indices, seed, ufactor, niter, leaf_size) -> torch.Tensor:
    ip, ix, out = _i64(indptr), _i64(indices), torch.empty(n, dtype=torch.int64)
    _call("sbtpu_nested_dissection", n, _p(ip), _p(ix), int(seed), int(ufactor), int(niter), int(leaf_size),
          _p(out))
    return out


def pulp(n, indptr, indices, seeds, k, cap, iters) -> torch.Tensor:
    ip, ix, sd, out = _i64(indptr), _i64(indices), _i64(seeds), torch.empty(n, dtype=torch.int64)
    _call("sbtpu_pulp", n, _p(ip), _p(ix), _p(sd), len(sd), int(k), float(cap), int(iters), _p(out))
    return out


def jaccard(n, indptr, indices, nnz) -> torch.Tensor:
    ip, ix, out = _i64(indptr), _i64(indices), torch.empty(nnz, dtype=torch.float32)
    _call("sbtpu_jaccard", n, _p(ip), _p(ix), _p(out, _F32P))
    return out


def triangles(n, indptr, indices, directed) -> int:
    ip, ix, out = _i64(indptr), _i64(indices), torch.zeros(1, dtype=torch.int64)
    _call("sbtpu_triangles", n, _p(ip), _p(ix), int(bool(directed)), _p(out))
    return int(out[0])


def partition_kway(n, indptr, indices, ewts, k, seed, ufactor, niter) -> torch.Tensor:
    ip, ix, out = _i64(indptr), _i64(indices), torch.empty(n, dtype=torch.int64)
    ew = None if ewts is None else _host(ewts, torch.float64)
    _call("sbtpu_partition_kway", n, _p(ip), _p(ix), _p(ew, _F64P), int(k), int(seed), int(ufactor), int(niter),
          _p(out))
    return out


def fill_in(n, indptr, indices) -> int:
    """Symbolic-factorization nnz(L) of the natural order."""
    ip, ix, out = _i64(indptr), _i64(indices), torch.zeros(1, dtype=torch.int64)
    _call("sbtpu_fill_in", n, _p(ip), _p(ix), _p(out))
    return int(out[0])
