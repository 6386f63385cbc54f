"""CSR relocation (row permutation, column relabel, per-row column sort):
the wrapper over kernel K4 and its plain version.

K4 (``csrc/relocate.cu``) replaces the in-kernel table gather of
``tools/pallas_attempts.py::build_vector_gather`` and the radix kernels'
dynamic-store placement where the main path needs them, and takes over the
body of ``_permute_csr`` (the JAX ``sparsebase_tpu/ops/permute.py:70-129``
and ``models/pipelines.py:139-171``). Old row ``r`` moves as one block to
row ``row_order[r]``; each column ``c`` becomes ``col_order[c]``; inside a
row the entries are ordered by (new column, old in-row position). That key
is unique, so the kernel's result equals the plain version's stable sort
bit for bit, duplicate coordinates included.

On the card a warp takes 32 rows at a time and sorts those of up to 32
entries in shared memory; the same pass lists the longer rows on the
device. A block each sorts the listed rows of up to ``BLOCK_MAX`` entries,
reading the list's length from device memory, and K5 (``radix_argsort``)
the rows over ``BLOCK_MAX`` on a (row, new column) key. A call syncs with
the host once, to read how many rows are over ``BLOCK_MAX`` (only when the
matrix has enough entries to hold one); where there are such rows, their
route reads their total length as well (K5 itself reads nothing back).
The route runs in the span ``sbtorch:relocate:long_rows``; the counters
``relocate.entries``, ``relocate.long_rows`` and
``relocate.long_row_entries`` take the entries of each call on the card,
the rows over ``BLOCK_MAX`` and their entries, from the values the host
reads anyway.
float32 values and pattern matrices ride in the kernel; for any other
value dtype the kernel writes each entry's source position and the wrapper
gathers ``vals[src]``. The kernel takes int64 offsets and int32 ids: other
integer types are converted before the launch (offsets widened, ids
narrowed by a checked cast, which reads their range back to the host) and
the new ids come back in the caller's type. The new ``indptr`` stays a
torch op: ``counts[row_order] = degrees`` and a cumsum, both n-sized. CPU
tensors take the plain version; CUDA tensors launch the kernel, or the
wrapper raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..._build import Kernel
from ...convert.kernels import expand_row_table, indptr_from_counts, sort_by_pairs_plain
from ...formats.csr import CSR
from ...utils.exceptions import TypeMismatchError
from ...utils.tracing import count, span
from ._args import kernel_ids, kernel_offsets
from .radix import bits_below, radix_argsort

WARP_MAX = 32  # rows up to this degree: sorted by the warp tier (kWarpMax in csrc/relocate.cu)
BLOCK_MAX = 4096  # rows up to this degree: one block each (kBlockMax)
_PATTERN, _FLOAT, _SOURCE = 0, 1, 2  # value routes (Payload in csrc/relocate.cu)

_K4 = Kernel(
    "relocate_csr",
    "sb_relocate_csr",
    [ctypes.c_void_p] * 6
    + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64]
    + [ctypes.c_void_p] * 5,
)


def long_row_capacity(nrows: int, nnz: int):
    """Slots the kernel's two device lists need at most: rows of
    ``WARP_MAX + 1`` to ``BLOCK_MAX`` entries, and rows of more."""
    return min(nrows, nnz // (WARP_MAX + 1)), min(nrows, nnz // (BLOCK_MAX + 1))


def _new_indptr(csr: CSR, row_order: Optional[torch.Tensor]) -> torch.Tensor:
    if row_order is None:
        return csr.indptr
    counts = torch.empty_like(csr.indptr[1:])
    counts[row_order] = csr.degrees()  # a bijection: every slot is written once
    return indptr_from_counts(counts)


def relocate_csr_plain(
    csr: CSR, row_order: Optional[torch.Tensor] = None, col_order: Optional[torch.Tensor] = None
) -> CSR:
    """Relabel rows over their blocks and columns by one gather, then one
    stable sort of the packed (row, col) key carrying the values."""
    idt = csr.indices.dtype
    if row_order is None:
        new_row = csr.row_of_nnz()
    else:
        new_row = expand_row_table(row_order.to(idt), csr.indptr, csr.nnz)
    new_col = csr.indices if col_order is None else col_order.to(idt)[csr.indices]
    _, col_s, vals_s = sort_by_pairs_plain(new_row, new_col, csr.vals)
    return CSR(_new_indptr(csr, row_order), col_s, vals_s, csr.shape)


def relocate_csr(
    csr: CSR, row_order: Optional[torch.Tensor] = None, col_order: Optional[torch.Tensor] = None
) -> CSR:
    """The CSR with row ``r`` moved to ``row_order[r]``, column ``c``
    relabelled ``col_order[c]`` (None: identity) and every row's columns
    sorted, ties in input order. Both orders are inverse permutations
    ``order[old] = new`` on the CSR's device."""
    tensors = [t for t in (csr.indptr, csr.indices, csr.vals, row_order, col_order) if t is not None]
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return relocate_csr_plain(csr, row_order, col_order)
    if len(devices) != 1 or csr.indptr.device.type != "cuda":
        raise TypeMismatchError(f"relocate_csr: tensors on {sorted(map(str, devices))}; need one CUDA device")
    if csr.indptr.shape != (csr.nrows + 1,):
        raise ValueError("relocate_csr: indptr length is not nrows + 1")
    for order, size, what in ((row_order, csr.nrows, "row_order"), (col_order, csr.ncols, "col_order")):
        if order is not None and order.shape != (size,):
            raise ValueError(f"relocate_csr: {what} has shape {tuple(order.shape)}, expected ({size},)")
    dev, nnz = csr.indices.device, csr.nnz
    count("relocate.entries", nnz)
    id_dtype = csr.indices.dtype
    ro = None if row_order is None else row_order.to(torch.int32).contiguous()
    co = None if col_order is None else col_order.to(torch.int32).contiguous()
    given_indptr = _new_indptr(csr, ro)  # what the plain version gives back, in its type
    new_indptr = kernel_offsets(given_indptr, "relocate_csr indptr")
    if nnz == 0:
        return CSR(given_indptr, csr.indices.clone(), None if csr.vals is None else csr.vals.clone(), csr.shape)
    indptr = kernel_offsets(csr.indptr, "relocate_csr indptr")
    indices = kernel_ids(csr.indices, "relocate_csr column ids")
    out_indices = torch.empty((nnz,), dtype=torch.int32, device=dev)
    vals = None if csr.vals is None else csr.vals.contiguous()
    out_vals = out_src = None
    if vals is None:
        route = _PATTERN
    elif vals.dtype == torch.float32:
        route, out_vals = _FLOAT, torch.empty_like(vals)
    else:
        route, out_src = _SOURCE, torch.empty((nnz,), dtype=torch.int64, device=dev)
    block_cap, over_cap = long_row_capacity(csr.nrows, nnz)
    rows = torch.empty((block_cap + over_cap,), dtype=torch.int32, device=dev)
    counts = torch.empty((2,), dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _K4.launch(
            indptr.data_ptr(), indices.data_ptr(), ptr(vals if route == _FLOAT else None), ptr(ro), ptr(co),
            new_indptr.data_ptr(), csr.nrows, route, rows.data_ptr(), block_cap, counts.data_ptr(),
            out_indices.data_ptr(), ptr(out_vals), ptr(out_src), stream,
        )
    if over_cap:
        over = int(counts[1])  # the one host sync: rows over BLOCK_MAX
        count("relocate.long_rows", over)
        if over:
            with span("sbtorch:relocate:long_rows"):
                _sort_rows_over_cap(rows[block_cap:block_cap + over], indptr, indices, vals, ro, co, new_indptr,
                                    out_indices, out_vals, out_src, csr.ncols)
    if route == _SOURCE:
        out_vals = vals[out_src]
    return CSR(given_indptr, out_indices.to(id_dtype), out_vals, csr.shape)


def _sort_rows_over_cap(rows, indptr, indices, vals, ro, co, new_indptr, out_indices, out_vals, out_src, ncols):
    """Rows of more than ``BLOCK_MAX`` entries: gather them, sort by the key
    (row, new column) with K5 (stable: ties keep the in-row order; it runs
    only the digits that ``ncols`` columns and this many rows can fill), and
    write each row's block where K4 would have."""
    starts = indptr[rows]
    degs = indptr[rows.long() + 1] - starts
    seg_start = indptr_from_counts(degs)
    total = int(seg_start[-1])
    count("relocate.long_row_entries", total)
    seg = torch.repeat_interleave(torch.arange(rows.numel(), device=rows.device), degs, output_size=total)
    local = torch.arange(total, device=rows.device) - seg_start[seg]
    src = starts[seg] + local
    col = indices[src]
    if co is not None:
        col = co[col]
    live_bits = [(0, bits_below(ncols)), (32, 32 + bits_below(rows.numel()))]
    perm = radix_argsort((seg << 32) | col.to(torch.int64), key_bits=live_bits)
    dst = new_indptr[rows.long() if ro is None else ro[rows.long()].long()][seg] + local
    out_indices[dst] = col[perm]
    if out_vals is not None:
        out_vals[dst] = vals[src[perm]]
    if out_src is not None:
        out_src[dst] = src[perm]
