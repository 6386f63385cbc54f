"""One round of size-constrained label propagation: the wrapper over kernel
K7 and its plain version.

K7 (``csrc/label_prop.cu``) replaces the XLA round of the JAX package's
``ops/partition/labelprop.py::_propagate`` (:160) with its
``_neighbor_counts`` (:78). For each row ``r`` of a CSR, with ``labels`` in
``[0, k)``:

* ``counts[r, p]``: the entries ``j`` of row ``r`` with
  ``labels[indices[j]] == p`` (with float32 ``weights``, the sum of theirs,
  taken in entry order);
* ``sizes[p]``: the vertices labelled ``p``;
* ``pen[p] = alpha * max(sizes[p] - cap, 0) * (max(counts) + 1) / max(cap, 1)``
  in float32, in that order, ``max(counts)`` over all ``(r, p)``;
* the new label of ``r``: the first ``p`` of the largest
  ``counts[r, p] - pen[p]``; a row with no entries keeps its label.

The python numbers ``alpha``, ``cap`` and ``max(cap, 1)`` are rounded to
float32 first, as numpy and JAX round a Python float that meets a float32
array. The division is a division: a CUDA division by a Python number is a
multiply by its reciprocal, so the plain version divides by a 0-d tensor on
the device, and the kernel by ``__fdiv_rn``. A label outside ``[0, k)`` (the
caller's invariant forbids it) is skipped by both.

CPU tensors take the plain version; CUDA tensors launch the kernel, or the
wrapper raises. Unweighted counts are integers, so the kernel's labels
equal the plain version's bit for bit; weighted ones sum each cell in entry
order, as ``np.add.at`` does and as the plain version's ``index_add_`` does
on the CPU (on the card its sums take another order).

Where ``n * k <= nnz`` (and k <= 6,140) the kernel reads the entries once
and keeps each row's k cells in the scratch between its launches, so the
scratch the wrapper allocates (``_scratch_bytes``, the kernel's own plan)
holds ``4 * n * k`` bytes more; otherwise it counts each row twice. Where
``k <= 255`` the scratch also holds a 1-byte copy of the labels (n bytes),
which the kernel gathers from. Unweighted with the cells stored and ``k <=
8``, the rows of more than ``SPLIT_ROWS`` entries (a skewed graph's hubs)
are counted by a span pass that cuts their entries into equal spans, one a
warp: the scratch holds room for the rows it may take (24 bytes a row, at
most ``nnz / (SPLIT_ROWS + 1)`` rows), and each such round adds one to the
counter ``label_prop.split_rounds``. ``split_rows`` reports what takes it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..._build import Kernel, library
from ...formats.csr import CSR
from ...utils.exceptions import TypeMismatchError
from ...utils.tracing import count
from ._args import kernel_ids, kernel_offsets

_K7 = Kernel(
    "label_prop",
    "sb_label_prop_round",
    [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 3,
)


SPLIT_ROWS = 1024  # longer rows go to K7's span pass (csrc/label_prop.cu: kSplitRows)


@functools.cache
def _scratch_bytes():
    """K7's ``sb_label_prop_scratch_bytes(n, k, nnz)``: the bytes of the
    scratch that holds the part sizes, the largest count, the penalties, the
    1-byte labels (``k <= 255``) and the stored cells (where ``n * k <=
    nnz``) or, past the shared-memory tier, the histograms."""
    fn = library().sb_label_prop_scratch_bytes
    fn.argtypes, fn.restype = [ctypes.c_int64] * 3, ctypes.c_int64
    return fn


@functools.cache
def _splits():
    """K7's ``sb_label_prop_splits(n, k, nnz, weighted)``: 1 where a round's
    plan includes the span pass (whether any row takes it is read on the
    card alone), else 0."""
    fn = library().sb_label_prop_splits
    fn.argtypes, fn.restype = [ctypes.c_int64] * 3 + [ctypes.c_int], ctypes.c_int
    return fn


def split_rows(csr: CSR) -> Tuple[int, int]:
    """``(rows, entries)``: the rows of ``csr`` longer than ``SPLIT_ROWS``
    entries and the entries they hold, which K7's span pass counts where a
    round's plan includes it. Torch ops and one host read, for tests and
    reports; no pipeline calls it."""
    deg = csr.indptr[1:] - csr.indptr[:-1]
    long = deg > SPLIT_ROWS
    rows, entries = torch.stack([long.sum(), torch.where(long, deg, 0).sum()]).tolist()
    return rows, entries


def _scalar(value: float, device) -> torch.Tensor:
    """``value`` rounded to float32, as a 0-d tensor on ``device`` (a fill:
    no copy from the host)."""
    return torch.full((), value, dtype=torch.float32, device=device)


def neighbor_counts(csr: CSR, labels: torch.Tensor, k: int, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``(n, k)`` float32 histogram of the labels of each row's entries
    (each entry's weight, with ``weights``), by ``index_add_`` into the flat
    cells, which adds in entry order on the CPU (an accumulating
    ``index_put_`` there splits the entries among threads); entries whose
    label is outside ``[0, k)`` add nothing."""
    row = csr.row_of_nnz().long()
    lab = labels.long()[csr.indices.long()]
    valid = (lab >= 0) & (lab < k)
    vals = torch.ones_like(lab, dtype=torch.float32) if weights is None else weights.to(torch.float32)
    out = torch.zeros((csr.nrows * k,), dtype=torch.float32, device=labels.device)
    out.index_add_(0, row * k + torch.where(valid, lab, 0), torch.where(valid, vals, 0.0))
    return out.view(csr.nrows, k)


def part_counts(labels: torch.Tensor, k: int) -> torch.Tensor:
    """Vertices per label in ``[0, k)`` (int64), by ``scatter_add_``."""
    lab = labels.long()
    valid = (lab >= 0) & (lab < k)
    out = torch.zeros((k,), dtype=torch.int64, device=labels.device)
    return out.scatter_add_(0, torch.where(valid, lab, 0), valid.to(torch.int64))


def penalty_plain(counts: torch.Tensor, sizes: torch.Tensor, alpha: float, cap: float) -> torch.Tensor:
    """``alpha * max(sizes - cap, 0) * (counts.max() + 1) / max(cap, 1)`` in
    float32, in that order, every Python number rounded to float32 first."""
    dev = counts.device
    over = torch.clamp_min(sizes.to(torch.float32) - _scalar(cap, dev), 0.0)
    return _scalar(alpha, dev) * over * (counts.amax() + 1.0) / _scalar(max(cap, 1.0), dev)


def label_prop_round_plain(csr: CSR, labels: torch.Tensor, k: int, alpha: float, cap: float,
                           weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One round as torch ops: the neighbour-label histogram, the part
    sizes, the penalty and a first-index ``argmax``; int32 labels."""
    if csr.nrows == 0:
        return labels.to(torch.int32)
    counts = neighbor_counts(csr, labels, k, weights)
    pen = penalty_plain(counts, part_counts(labels, k), alpha, cap)
    new = torch.argmax(counts - pen[None, :], dim=1).to(torch.int32)
    return torch.where(csr.degrees() > 0, new, labels.to(torch.int32))


def label_prop_round(csr: CSR, labels: torch.Tensor, k: int, alpha: float, cap: float,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One round of label propagation (see the module's docstring): the new
    int32 labels, on ``csr``'s device. ``labels`` has one entry per row and
    names the part of each vertex (every column id must name a row);
    ``weights``, one per entry, weigh the counts. A call reads nothing back
    to the host; on the card, one whose plan includes the span pass counts
    ``label_prop.split_rounds``."""
    if csr.ncols > csr.nrows:
        raise ValueError(f"label_prop: shape {csr.shape} has more columns than rows; every id must name a row")
    if csr.indptr.device.type == "cpu" and labels.device.type == "cpu":
        return label_prop_round_plain(csr, labels, k, alpha, cap, weights)
    dev = csr.indptr.device
    if dev.type != "cuda" or labels.device != dev or (weights is not None and weights.device != dev):
        raise TypeMismatchError(f"label_prop: CSR on {dev}, labels on {labels.device}; need one CUDA device (or "
                                "the CPU)")
    n = csr.nrows
    if labels.shape != (n,):
        raise ValueError(f"label_prop: {tuple(labels.shape)} labels for {n} rows")
    if weights is not None and weights.shape != (csr.nnz,):
        raise ValueError(f"label_prop: {tuple(weights.shape)} weights for {csr.nnz} entries")
    if k < 1 or k >= 2**31:
        raise ValueError(f"label_prop: k = {k} parts")
    if n == 0:
        return torch.empty((0,), dtype=torch.int32, device=dev)
    indptr = kernel_offsets(csr.indptr, "label_prop indptr")
    ids = kernel_ids(csr.indices, "label_prop ids")
    lab = labels.to(torch.int32).contiguous()
    w = None if weights is None else weights.to(torch.float32).contiguous()
    scratch = torch.empty((_scratch_bytes()(n, k, csr.nnz),), dtype=torch.uint8, device=dev)
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _K7.launch(indptr.data_ptr(), ids.data_ptr(), None if w is None else w.data_ptr(), lab.data_ptr(), n, csr.nnz,
                   k, alpha, cap, max(cap, 1.0), scratch.data_ptr(), out.data_ptr(), stream)
    if _splits()(n, k, csr.nnz, w is not None):
        count("label_prop.split_rounds")
    return out
