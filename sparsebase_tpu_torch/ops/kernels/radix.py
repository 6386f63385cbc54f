"""Stable integer sort: the wrapper over kernel K5 and its plain versions.

K5 (``csrc/radix_sort.cu``) is a stable LSD radix sort with 8-bit digits,
the exact and global form of the radix-partition Pallas kernels
``tools/pallas_attempts.py::build_radix_scalar`` and ``::build_radix_matmul``.
It returns the sorting permutation (:func:`radix_argsort`) or its inverse,
the rank (:func:`radix_rank`), and takes over the stable ``torch.argsort``
of ``ranks_from_sort_keys``. CPU tensors take the plain versions; CUDA
tensors launch the kernel, or the wrapper raises.

Keys are any integer tensor. On the card they are shifted by their minimum
(order and ties unchanged), and the number of 8-bit passes comes from the
largest shifted key: reading the minimum and maximum is one host sync per
call.
"""

from __future__ import annotations

import ctypes

import torch

from ..._build import Kernel
from ...utils.exceptions import TypeMismatchError

TILE = 4096  # keys per block per pass (kTile in csrc/radix_sort.cu)
_INT_DTYPES = (torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64)

_K5 = Kernel(
    "radix_rank",
    "sb_radix_sort",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int]
    + [ctypes.c_void_p] * 6
    + [ctypes.c_int, ctypes.c_void_p],
)


def radix_argsort_plain(keys: torch.Tensor) -> torch.Tensor:
    """``perm[new] = old`` of a stable ascending sort (int32)."""
    return torch.argsort(keys, stable=True).to(torch.int32)


def radix_rank_plain(keys: torch.Tensor) -> torch.Tensor:
    """``rank[old] = new`` of a stable ascending sort (int32)."""
    perm = torch.argsort(keys, stable=True)
    n = keys.shape[0]
    rank = torch.empty((n,), dtype=torch.int32, device=keys.device)
    rank[perm] = torch.arange(n, dtype=torch.int32, device=keys.device)
    return rank


def radix_argsort(keys: torch.Tensor) -> torch.Tensor:
    """Permutation of a stable ascending sort, ``perm[new] = old`` (int32)."""
    if keys.device.type == "cpu":
        return radix_argsort_plain(keys)
    return _radix_sort(keys, inverse=False)


def radix_rank(keys: torch.Tensor) -> torch.Tensor:
    """Rank of each key under a stable ascending sort, ``rank[old] = new``
    (int32): equal keys keep their input order."""
    if keys.device.type == "cpu":
        return radix_rank_plain(keys)
    return _radix_sort(keys, inverse=True)


def _radix_sort(keys: torch.Tensor, inverse: bool) -> torch.Tensor:
    if keys.device.type != "cuda":
        raise TypeMismatchError(f"radix sort: keys on {keys.device}; need the CPU or a CUDA device")
    if keys.dtype not in _INT_DTYPES or keys.dim() != 1:
        raise TypeMismatchError(f"radix sort: needs 1-D integer keys, got {keys.dtype} of {keys.dim()} dims")
    n = keys.numel()
    if n >= 2**31:
        raise ValueError(f"radix sort: {n} keys; int32 ids take fewer than 2^31")
    out = torch.empty((n,), dtype=torch.int32, device=keys.device)
    if n == 0:
        return out
    lo, hi = (int(v) for v in torch.aminmax(keys))  # the one host sync
    span = hi - lo
    # shifted keys: 32-bit where the span fits, else 64-bit (a span past
    # 2^63 wraps in int64 and reads back right as uint64)
    if span < 2**31:
        narrow = lo == 0 and keys.dtype == torch.int32
        shifted = keys if narrow else (keys.to(torch.int64) - lo).to(torch.int32)
    else:
        shifted = keys.to(torch.int64) - lo
    shifted = shifted.contiguous()
    key_bytes = shifted.element_size()
    passes = max(1, -(-span.bit_length() // 8))
    nblocks = -(-n // TILE)
    hist = torch.empty((256 * (nblocks + 1),), dtype=torch.int32, device=keys.device)
    key_bufs = [torch.empty_like(shifted) if passes > 1 + i else None for i in range(2)]
    id_bufs = [torch.empty_like(out) if passes > 1 + i else None for i in range(2)]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        _K5.launch(
            shifted.data_ptr(), key_bytes, n, passes,
            ptr(key_bufs[0]), ptr(key_bufs[1]), ptr(id_bufs[0]), ptr(id_bufs[1]),
            hist.data_ptr(), out.data_ptr(), int(inverse), stream,
        )
    return out
