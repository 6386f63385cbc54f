"""Per-entry common-neighbour counts of a CSR: the wrapper over kernel K6 and
its plain version.

K6 (``csrc/common_neighbors.cu``) replaces the two XLA tiers of the JAX
package that count, for every stored entry ``e = (u, v)``, the members of
``N(u)`` that lie in ``N(v)``: ``ops/feature/sparse_common.py::_group_runner``
(the chunked binary search, host-chunked against the TPU watchdog) and
``ops/feature/jaccard.py::_jaccard_device`` (the flat ragged expansion). Three
modes:

* ``"jaccard"``: ``c`` counts every instance of ``N(u)`` that is a member of
  ``N(v)``; the result is the float32 ``(nnz,)`` tensor of
  ``c / max(deg u + deg v - c, 1)``, divided in float64 and rounded, as the
  JAX ``_jaccard_host`` does.
* ``"triangles"``: an entry with ``u == v``, or equal to the entry before it
  in its row, counts 0; any other counts the distinct ids of both lists other
  than ``u`` and ``v``. The result is the 0-d int64 sum over the entries: six
  times the triangle count of a symmetric pattern.
* ``"directed"``: an entry with ``v <= u``, or equal to the entry before it,
  counts 0; any other counts the distinct ``w`` of ``N(v)`` with ``w > u`` and
  ``w != v`` that are row ids of column ``u`` (the ``csc`` argument, the same
  matrix in CSC form). Each is a 3-cycle ``u -> v -> w -> u`` anchored at its
  least vertex: the 0-d int64 sum is the directed 3-cycle count, self-loops
  ignored. The JAX package has no sparse form of it (its TPU route is a dense
  product up to 16,384 vertices and the host past it).

All need a CSR whose rows are sorted (``CSR.new`` and every conversion give
one) and no more columns than rows, so that every id names a row; directed
mode needs a square one. CPU tensors take the plain version; CUDA tensors
launch the kernel, or the wrapper raises.

The plain version takes each entry's candidates from the shorter of its two
lists and searches them in the other. The kernel works by row: it groups
the rows by entry count on the card, stages each row's list once and, per
entry, streams the other list through it or searches the staged ids in the
other list, whichever costs less (the counts are the same: see the kernel's
source).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..._build import Kernel, library
from ...formats.csc import CSC
from ...formats.csr import CSR
from ...utils.exceptions import TypeMismatchError
from ._args import kernel_ids, kernel_offsets

MODES = ("jaccard", "triangles", "directed")
# candidate slots the plain version expands at once: each slot holds about
# ten int64 temporaries, so 2^26 slots take about 5 GiB of the card's 80 GB
# beside a graph of 68M entries (its per-entry arrays take about 8 GiB)
PLAIN_CHUNK_SLOTS = 1 << 26
# K6's queue of entries whose two lists are both long: a slot per
# DEFER_SLOTS_PER entries, at least DEFER_MIN_SLOTS (the kernel counts an
# entry in place when the queue is full)
DEFER_SLOTS_PER = 16
DEFER_MIN_SLOTS = 1024

_K6 = Kernel(
    "common_neighbors",
    "sb_common_neighbors",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_void_p] * 3,
)


@functools.cache
def _scratch_words():
    """K6's ``sb_common_neighbors_scratch_words(n, cap)``: the int64 words
    of the scratch the kernel carves into its plan, its tiers' row lists and
    its queue."""
    fn = library().sb_common_neighbors_scratch_words
    fn.argtypes, fn.restype = [ctypes.c_int64, ctypes.c_int64], ctypes.c_int64
    return fn


def check_ids_name_rows(csr: CSR) -> None:
    """Raise ``ValueError`` when ``csr`` has more columns than rows: a
    common-neighbour count reads the row of every column id. The check reads
    the shape only, no device memory."""
    if csr.ncols > csr.nrows:
        raise ValueError(f"common_neighbors: shape {csr.shape} has more columns than rows; every id must name a row")


def _check(csr: CSR, mode: str, csc) -> None:
    if mode not in MODES:
        raise ValueError(f"common_neighbors: mode {mode!r}, expected one of {MODES}")
    check_ids_name_rows(csr)
    if mode == "directed":
        if not isinstance(csc, CSC) or csc.shape != csr.shape or csr.nrows != csr.ncols or csc.nnz != csr.nnz:
            raise ValueError("common_neighbors: directed mode needs a square CSR and its CSC (csc=)")
        if csc.indptr.shape != (csr.ncols + 1,):
            raise ValueError("common_neighbors: CSC indptr length is not ncols + 1")


def _empty(mode: str, device) -> torch.Tensor:
    if mode == "jaccard":
        return torch.zeros((0,), dtype=torch.float32, device=device)
    return torch.zeros((), dtype=torch.int64, device=device)


def search_rounds(lengths: torch.Tensor) -> int:
    """Rounds of binary search that settle every segment of these lengths
    (one host read)."""
    return int(lengths.max()).bit_length() if lengths.numel() else 0


def lower_bound(ids: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, x: torch.Tensor, rounds: int,
                strict: bool = False) -> torch.Tensor:
    """Per element, the first position ``p`` in ``[lo, hi)`` with
    ``ids[p] >= x`` (``> x`` when ``strict``), ``hi`` if none: a binary
    search vectorised over the elements, ``rounds`` steps."""
    left, right = lo.clone(), hi.clone()
    last = max(ids.numel() - 1, 0)
    for _ in range(rounds):
        active = left < right
        mid = (left + right) // 2
        at = ids[mid.clamp(max=last)]
        go = active & ((at <= x) if strict else (at < x))
        left = torch.where(go, mid + 1, left)
        right = torch.where(active & ~go, mid, right)
    return left


def common_neighbors_plain(csr: CSR, mode: str, csc: CSC | None = None) -> torch.Tensor:
    """K6's function as torch ops: a ragged expansion of each entry's
    candidates, ``PLAIN_CHUNK_SLOTS`` slots at a time (plus at most one
    entry's list), with a vectorised binary search. It reads sizes back to
    the host."""
    _check(csr, mode, csc)
    dev, nnz = csr.indptr.device, csr.nnz
    if nnz == 0:
        return _empty(mode, dev)
    indptr = csr.indptr.to(torch.int64)
    ids = csr.indices.to(torch.int64)
    u, v = csr.row_of_nnz().to(torch.int64), ids
    su, eu, sv, ev = indptr[u], indptr[u + 1], indptr[v], indptr[v + 1]
    pos = torch.arange(nnz, device=dev)
    repeat = (pos > su) & (ids[(pos - 1).clamp(min=0)] == v)
    # both lists of an entry as ranges of ``lists``: N(u) and N(v), or, in
    # directed mode, N(v) and the column u of the CSC stored after the ids
    lists = ids
    if mode == "directed":
        lists = torch.cat([ids, csc.indices.to(torch.int64)])
        in_ptr = csc.indptr.to(torch.int64) + nnz
        su, eu = in_ptr[u], in_ptr[u + 1]
    du, dv = eu - su, ev - sv
    from_u = du <= dv  # candidates from the shorter list, the first on a tie
    cs, clen = torch.where(from_u, su, sv), torch.where(from_u, du, dv)
    ts, te = torch.where(from_u, sv, su), torch.where(from_u, ev, eu)
    if mode == "triangles":
        clen = torch.where((u == v) | repeat, 0, clen)
    elif mode == "directed":
        clen = torch.where((v <= u) | repeat, 0, clen)
    ends = torch.cumsum(clen, 0)
    starts = ends - clen
    # entries grouped by the chunk their first slot falls in
    _, sizes = torch.unique_consecutive(starts // PLAIN_CHUNK_SLOTS, return_counts=True)
    bounds = [0] + torch.cumsum(sizes, 0).tolist()
    count = torch.zeros((nnz,), dtype=torch.int64, device=dev)
    for e0, e1 in zip(bounds[:-1], bounds[1:]):
        base, slots = int(starts[e0]), int(ends[e1 - 1] - starts[e0])
        if slots == 0:
            continue
        owner = torch.repeat_interleave(torch.arange(e0, e1, device=dev), clen[e0:e1], output_size=slots)
        t = torch.arange(base, base + slots, device=dev) - starts[owner]
        p = cs[owner] + t
        x = lists[p]
        first = (t == 0) | (lists[(p - 1).clamp(min=0)] != x)
        lo, hi = ts[owner], te[owner]
        rounds = search_rounds(hi - lo)
        lb = lower_bound(lists, lo, hi, x, rounds)
        found = (lb < hi) & (lists[lb.clamp(max=lists.numel() - 1)] == x)
        if mode == "triangles":
            add = (found & first & (x != u[owner]) & (x != v[owner])).to(torch.int64)
        elif mode == "directed":
            add = (found & first & (x > u[owner]) & (x != v[owner])).to(torch.int64)
        else:
            # from N(u): every instance counts; from N(v): each distinct id
            # counts its multiplicity in N(u)
            mult = lower_bound(ids, lb, hi, x, rounds, strict=True) - lb
            add = torch.where(from_u[owner], found.to(torch.int64), torch.where(found & first, mult, 0))
        count.index_add_(0, owner, add)
    if mode != "jaccard":
        return count.sum()
    union = (du + dv - count).clamp(min=1)
    return (count.to(torch.float64) / union.to(torch.float64)).to(torch.float32)


def common_neighbors(csr: CSR, mode: str, csc: CSC | None = None) -> torch.Tensor:
    """Jaccard weights (float32, ``(nnz,)``), the triangle sum or the
    directed 3-cycle count (0-d int64) of a row-sorted CSR; ``csc`` is the
    same matrix as a CSC, read in directed mode only. On a CUDA CSR one
    launch of K6, no host read."""
    _check(csr, mode, csc)
    devices = {csr.indptr.device, csr.indices.device}
    if mode == "directed":
        devices |= {csc.indptr.device, csc.indices.device}
    if devices == {torch.device("cpu")}:
        return common_neighbors_plain(csr, mode, csc)
    if len(devices) != 1 or csr.indptr.device.type != "cuda":
        raise TypeMismatchError(f"common_neighbors: tensors on {sorted(map(str, devices))}; need one CUDA device")
    if csr.indptr.shape != (csr.nrows + 1,):
        raise ValueError("common_neighbors: indptr length is not nrows + 1")
    dev, nnz = csr.indices.device, csr.nnz
    if nnz == 0:
        return _empty(mode, dev)
    indptr = kernel_offsets(csr.indptr, "common_neighbors indptr")
    ids = kernel_ids(csr.indices, "common_neighbors column ids")
    if csr.nrows > torch.iinfo(torch.int32).max:
        raise TypeMismatchError(f"common_neighbors: {csr.nrows} rows; the kernel takes int32 row ids")
    in_ptr = in_ids = None
    if mode == "directed":
        in_ptr = kernel_offsets(csc.indptr, "common_neighbors CSC indptr")
        in_ids = kernel_ids(csc.indices, "common_neighbors CSC row ids")
    # the kernel's scratch, one allocation: its plan, its tiers' row lists and
    # its queue of entries whose two lists are both long
    n, cap = csr.nrows, max(DEFER_MIN_SLOTS, nnz // DEFER_SLOTS_PER)
    scratch = torch.empty((_scratch_words()(n, cap),), dtype=torch.int64, device=dev)
    jaccard = mode == "jaccard"
    out = torch.empty((nnz,) if jaccard else (1,), dtype=torch.float32 if jaccard else torch.int64, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _K6.launch(indptr.data_ptr(), ids.data_ptr(), n, nnz, MODES.index(mode), ptr(in_ptr), ptr(in_ids),
                   scratch.data_ptr(), cap, out.data_ptr() if jaccard else None, None if jaccard else out.data_ptr(),
                   stream)
    return out if jaccard else out.reshape(())
