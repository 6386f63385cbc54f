"""Stable integer sort: the wrapper over kernel K5 and its plain versions.

K5 (``csrc/radix_sort.cu``) is a stable LSD radix sort with digits of up to
8 bits, the exact and global form of the radix-partition Pallas kernels
``tools/pallas_attempts.py::build_radix_scalar`` and ``::build_radix_matmul``.
It returns the sorting permutation (:func:`radix_argsort`, on request with
the sorted keys) or its inverse, the rank (:func:`radix_rank`). CPU tensors
take the plain versions; CUDA tensors launch the kernel, or the wrapper
raises.

Keys are any integer tensor, read by the kernel in place: int32 and int64 as
they are, narrower types after one widening cast. A call reads nothing back
to the host. The digit passes are planned here from what the caller states
about the keys (:func:`plan_passes`), and thinned on the device, where a
digit on which all keys agree is skipped:

* ``key_bits=None``: nothing is known. Every byte of the key type is
  planned, and the top digit flips the sign bit, so negative keys sort first.
* ``key_bits=k``: every key is in ``[0, 2**k)``.
* ``key_bits=[(lo, hi), ...]``: the keys are non-negative and only the bits
  ``lo <= b < hi`` of each range can be set, as in a packed pair
  ``(major << 32) | minor``.

A key outside what ``key_bits`` states is sorted by its stated bits alone.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple, Union

import torch

from ..._build import Kernel
from ...utils.exceptions import TypeMismatchError

TILE = 4096  # keys per block per pass (kTile in csrc/radix_sort.cu)
MAX_PASSES = 8  # kMaxPasses
HEADER_BYTES = 32768  # kHeaderBytes: histograms, scans and the device's plan
_SLOT_BYTES = 256 * 8  # per tile: one look-back word per digit value
_INT_DTYPES = (torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64)

KeyBits = Union[None, int, Sequence[Tuple[int, int]]]

_K5 = Kernel(
    "radix_rank",
    "sb_radix_sort",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    + [ctypes.c_void_p] * 5
    + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
)


def bits_below(bound: int) -> int:
    """Bits that can be set in an integer of ``[0, bound)``; 0 when only 0 is."""
    return max(int(bound) - 1, 0).bit_length()


def plan_passes(total_bits: int, key_bits: KeyBits = None) -> List[Tuple[int, int, int]]:
    """The digit passes of a sort of ``total_bits``-bit keys, low digit
    first: ``(shift, bits, flip)`` with ``bits`` in 1..8; ``flip`` is 1 on
    the digit whose top bit is the sign bit of keys about which nothing is
    stated. Each stated range of live bits is cut into digits of 8 bits and
    a narrower last one; there is always at least one pass."""
    if key_bits is None:
        ranges, signed = [(0, total_bits)], True
    elif isinstance(key_bits, int):
        ranges, signed = [(0, key_bits)], False
    else:
        ranges, signed = sorted((int(lo), int(hi)) for lo, hi in key_bits), False
    passes, reach = [], 0
    for lo, hi in ranges:
        if lo < reach or hi < lo or hi > total_bits - (0 if signed else 1):
            raise ValueError(f"key_bits {key_bits!r}: ranges must ascend, not overlap and end below the sign bit "
                             f"of a {total_bits}-bit key")
        reach = hi
        for shift in range(lo, hi, 8):
            passes.append((shift, min(8, hi - shift), 0))
    if not passes:
        passes = [(0, 1, 0)]  # keys stated to be all 0: one pass writes the identity
    if signed:
        shift, bits, _ = passes[-1]
        passes[-1] = (shift, bits, 1)
    if len(passes) > MAX_PASSES:
        raise ValueError(f"key_bits {key_bits!r} need {len(passes)} passes; the kernel takes {MAX_PASSES}")
    return passes


def scratch_bytes(n: int) -> int:
    """Bytes of device scratch one sort of ``n`` keys needs beside its key
    and id buffers: the header and one look-back slot per tile and digit value."""
    return HEADER_BYTES + _SLOT_BYTES * -(-n // TILE)


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


def radix_passes_plain(keys: torch.Tensor, key_bits: KeyBits = None, inverse: bool = False):
    """The kernel's pass logic as torch ops, for the tests: the planned
    digits low to high, the top one with its sign bit flipped where nothing
    is stated; a digit on which all keys agree is skipped, except the first;
    each pass that runs is one stable partition by its digit; the last one
    gives the permutation, or the rank with ``inverse``. Returns ``(result,
    passes that ran)``."""
    wide = (keys if keys.element_size() >= 4 else keys.to(torch.int32)).to(torch.int64)
    passes = plan_passes(8 * max(keys.element_size(), 4), key_bits)
    n = keys.numel()
    ids = torch.arange(n, dtype=torch.int32, device=keys.device)
    ran = []
    for p, (shift, bits, flip) in enumerate(passes):
        digit = ((wide >> shift) & ((1 << bits) - 1)) ^ (flip << (bits - 1))
        if p > 0 and (n == 0 or bool((digit == digit[0]).all())):
            continue
        order = torch.argsort(digit, stable=True)
        wide, ids = wide[order], ids[order]
        ran.append(p)
    if not inverse:
        return ids, ran
    rank = torch.empty_like(ids)
    rank[ids.long()] = torch.arange(n, dtype=torch.int32, device=keys.device)
    return rank, ran


def radix_argsort(keys: torch.Tensor, key_bits: KeyBits = None, return_keys: bool = False):
    """Permutation of a stable ascending sort, ``perm[new] = old`` (int32);
    with ``return_keys``, ``(perm, sorted_keys)``."""
    if keys.device.type == "cpu":
        perm = radix_argsort_plain(keys)
        return (perm, keys[perm.long()]) if return_keys else perm
    perm, sorted_keys = _radix_sort(keys, key_bits, inverse=False, return_keys=return_keys)
    return (perm, sorted_keys) if return_keys else perm


def radix_rank(keys: torch.Tensor, key_bits: KeyBits = None) -> torch.Tensor:
    """Rank of each key under a stable ascending sort, ``rank[old] = new``
    (int32): equal keys keep their input order."""
    if keys.device.type == "cpu":
        return radix_rank_plain(keys)
    return _radix_sort(keys, key_bits, inverse=True, return_keys=False)[0]


def radix_unique(keys: torch.Tensor, key_bits: KeyBits = None) -> torch.Tensor:
    """The distinct keys in ascending order: the stable sort (K5 on a card)
    and the first key of each run of equal ones."""
    _, keys = radix_argsort(keys, key_bits=key_bits, return_keys=True)
    first = torch.ones((keys.numel(),), dtype=torch.bool, device=keys.device)
    first[1:] = keys[1:] != keys[:-1]
    return keys[first]


def _radix_sort(keys: torch.Tensor, key_bits: KeyBits, inverse: bool, return_keys: bool):
    if keys.device.type != "cuda":
        raise TypeMismatchError(f"radix sort: keys on {keys.device}; need the CPU or a CUDA device")
    if keys.dtype not in _INT_DTYPES or keys.dim() != 1:
        raise TypeMismatchError(f"radix sort: needs 1-D integer keys, got {keys.dtype} of {keys.dim()} dims")
    n = keys.numel()
    if n >= 2**31:
        raise ValueError(f"radix sort: {n} keys; int32 ids take fewer than 2^31")
    dev = keys.device
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return out, (keys.clone() if return_keys else None)
    wide = keys if keys.element_size() >= 4 else keys.to(torch.int32)  # order and sign kept
    wide = wide.contiguous()
    passes = plan_passes(8 * wide.element_size(), key_bits)
    plan = (ctypes.c_int * (3 * len(passes)))(*(v for ps in passes for v in ps))
    sorted_keys = torch.empty_like(wide) if return_keys else None
    scratch = torch.empty((scratch_bytes(n) // 8,), dtype=torch.int64, device=dev)
    key_bufs = [torch.empty_like(wide) if len(passes) > 1 + i else None for i in range(2)]
    id_bufs = [torch.empty_like(out) if len(passes) > 1 + i else None for i in range(2)]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _K5.launch(
            wide.data_ptr(), wide.element_size(), n, len(passes), plan,
            ptr(key_bufs[0]), ptr(key_bufs[1]), ptr(id_bufs[0]), ptr(id_bufs[1]),
            scratch.data_ptr(), 8 * scratch.numel(), out.data_ptr(), ptr(sorted_keys), 1 if inverse else 0, stream,
        )
    if sorted_keys is not None and sorted_keys.dtype != keys.dtype:
        sorted_keys = sorted_keys.to(keys.dtype)
    return out, sorted_keys
