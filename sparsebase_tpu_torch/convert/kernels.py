"""Format-conversion functions, as torch ops on the tensors' own device.

Counterpart of ``sparsebase_tpu/convert/kernels.py`` (reference
src/sparsebase/converter/converter_order_two.cc — COO→CSR :163-214,
CSR→COO :72-118, COO→CSC :21-70, CSR→CSC :120-128):

* ``indptr`` from row-sorted COO is kernel K3 on CUDA tensors
  (``ops/kernels/indptr.py``; its plain version, one ``searchsorted`` of
  the row boundaries, on CPU tensors);
* row expansion is ``repeat_interleave`` with a known output size;
* a (major, minor) sort packs both int32 ids into one int64 key and sorts
  it once, stably: kernel K5 on CUDA tensors (``ops/kernels/radix.py``),
  ``torch.sort`` on CPU tensors. The CSC transposes are such a sort, by
  (column, row) or (row, column), followed by K3 on the sorted major ids.

None of them forms an out-of-range index, so nothing relies on JAX's
``mode="drop"`` dropping one: ``csr_to_ell`` checks the width against the
largest degree before it scatters.
"""

from __future__ import annotations

import torch

from ..formats.coo import COO
from ..formats.csc import CSC
from ..formats.csr import CSR
from ..formats.dia import DIA
from ..formats.ell import ELL
from ..utils.tracing import count, host_span


def indptr_from_sorted_rows(row: torch.Tensor, nrows: int) -> torch.Tensor:
    """CSR ``indptr`` (int64) from a row-sorted COO row array:
    ``indptr[r]`` = first position whose row is ``>= r`` (kernel K3)."""
    from ..ops.kernels.indptr import indptr_from_sorted_rows as k3  # ops imports this module

    return k3(row, nrows)


def expand_row_table(table: torch.Tensor, indptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """``out[k] = table[r(k)]`` over the CSR row blocks (empty rows emit
    nothing)."""
    return torch.repeat_interleave(table, indptr[1:] - indptr[:-1], output_size=nnz)


def _pack_pairs(major: torch.Tensor, minor: torch.Tensor) -> torch.Tensor:
    return (major.to(torch.int64) << 32) | minor.to(torch.int64)


def _unpack_sorted(key, order, major, minor, payload):
    out = [(key >> 32).to(major.dtype), (key & 0xFFFFFFFF).to(minor.dtype)]
    out += [None if p is None else p[order] for p in payload]
    return tuple(out)


def sort_by_pairs_plain(major: torch.Tensor, minor: torch.Tensor, *payload):
    """:func:`sort_by_pairs` as one stable ``torch.sort`` of the packed key
    (the CPU route, and the oracle of the card's)."""
    key, order = torch.sort(_pack_pairs(major, minor), stable=True)
    return _unpack_sorted(key, order, major, minor, payload)


def sort_by_pairs(major: torch.Tensor, minor: torch.Tensor, *payload, major_bound=None, minor_bound=None):
    """Stable sort of entries by (major, minor), carrying payload tensors.

    Both keys are non-negative int32 ids, packed as ``major << 32 | minor``
    into one int64 key. ``major_bound`` / ``minor_bound`` are exclusive
    bounds of the ids where the caller knows them (``nrows``, ``ncols``):
    on CUDA tensors kernel K5 then runs only the digits those ids can fill.
    Returns ``(major_sorted, minor_sorted, *payload_sorted)``; ``None``
    payloads pass through as ``None``."""
    if major.device.type == "cpu":
        return sort_by_pairs_plain(major, minor, *payload)
    from ..ops.kernels.radix import bits_below, radix_argsort  # ops imports this module

    minor_bits = 31 if minor_bound is None else bits_below(minor_bound)
    major_bits = 31 if major_bound is None else bits_below(major_bound)
    order, key = radix_argsort(_pack_pairs(major, minor), key_bits=[(0, minor_bits), (32, 32 + major_bits)],
                               return_keys=True)
    return _unpack_sorted(key, order, major, minor, payload)


def coo_to_csr(coo: COO) -> CSR:
    """COO→CSR relying on the row-major sort invariant
    (CooCsrFunctionConditional, converter_order_two.cc:163-214)."""
    indptr = indptr_from_sorted_rows(coo.row, coo.nrows)
    return CSR(indptr, coo.col, coo.vals, coo.shape)


def csr_to_coo(csr: CSR) -> COO:
    """Row expansion (CsrCooFunctionConditional, converter_order_two.cc:72-118)."""
    return COO(csr.row_of_nnz(), csr.indices, csr.vals, csr.shape)


def _order2_transpose_sort(major, minor, vals, n_major: int, minor_extent: int):
    """Stable sort of the entries by (major, minor); returns ``(indptr over
    the major ids, minor ids, vals)`` in that order (K5, then K3, on CUDA
    tensors)."""
    major_s, minor_s, vals_s = sort_by_pairs(major, minor, vals, major_bound=n_major, minor_bound=minor_extent)
    return indptr_from_sorted_rows(major_s, n_major), minor_s, vals_s


def coo_to_csc(coo: COO) -> CSC:
    """Sort by (column, row), then the column offsets
    (CooCscFunctionConditional, converter_order_two.cc:21-70)."""
    indptr, rows, vals = _order2_transpose_sort(coo.col, coo.row, coo.vals, coo.ncols, coo.nrows)
    return CSC(indptr, rows, vals, coo.shape)


def csc_to_coo(csc: CSC) -> COO:
    """CSC → row-major-sorted COO (the reference leaves CSC a sink)."""
    row, col, vals = sort_by_pairs(csc.indices, csc.col_of_nnz(), csc.vals, major_bound=csc.nrows,
                                   minor_bound=csc.ncols)
    return COO(row, col, vals, csc.shape)


def csr_to_csc(csr: CSR) -> CSC:
    """CSR → CSC by one transpose sort (the reference routes CSR → COO →
    CSC, converter_order_two.cc:120-128)."""
    indptr, rows, vals = _order2_transpose_sort(csr.indices, csr.row_of_nnz(), csr.vals, csr.ncols, csr.nrows)
    return CSC(indptr, rows, vals, csr.shape)


def csc_to_csr(csc: CSC) -> CSR:
    """CSC → CSR by one transpose sort."""
    indptr, cols, vals = _order2_transpose_sort(csc.indices, csc.col_of_nnz(), csc.vals, csc.nrows, csc.ncols)
    return CSR(indptr, cols, vals, csc.shape)


def csr_to_ell(csr: CSR, width=None) -> ELL:
    """CSR → ELL (row-padded). The largest degree is read back to the host
    once: it is the default width, and a given width below it raises
    ``ValueError``, so every slot the scatter writes is in range. Entry k of
    row r goes to slot ``r * width + (k - indptr[r])``."""
    n, m = csr.shape
    deg = csr.degrees()
    max_deg = int(deg.max()) if n > 0 else 0
    width = max_deg if width is None else int(width)
    if max_deg > width:
        raise ValueError(f"csr_to_ell: width {width} < max degree {max_deg}")
    width = max(width, 1)
    dev = csr.indices.device
    nnz = csr.nnz
    start = expand_row_table(csr.indptr[:-1], csr.indptr, nnz)
    flat = expand_row_table(torch.arange(n, device=dev) * width, csr.indptr, nnz)
    flat += torch.arange(nnz, device=dev) - start
    cols = torch.zeros((n * width,), dtype=torch.int32, device=dev)
    cols[flat] = csr.indices.to(torch.int32)
    vals = None
    if csr.vals is not None:
        vals = torch.zeros((n * width,), dtype=csr.vals.dtype, device=dev)
        vals[flat] = csr.vals
        vals = vals.view(n, width)
    return ELL(cols.view(n, width), vals, deg.to(torch.int32), (n, m))


def ell_to_csr(ell: ELL) -> CSR:
    """ELL → CSR: the valid slots in row-major order (the order within each
    row is kept); int32 ids and int64 offsets."""
    mask = ell.valid_mask()
    indices = ell.cols[mask].to(torch.int32)
    vals = None if ell.vals is None else ell.vals[mask]
    return CSR(indptr_from_counts(ell.lens), indices, vals, ell.shape)


def csr_to_dia(csr: CSR) -> DIA:
    """CSR → DIA. The present offsets (col - row) are found with one
    ``unique`` (a host sync: they size the band). Storage is O(diagonals ·
    n): use on banded matrices. The band fills by one of two routes, picked
    by the input alone:

    * scatter, when every row's column ids strictly ascend (as ``CSR.new``
      leaves them, unless a coordinate repeats): each entry has a (diagonal,
      row) cell of its own, so one scatter without accumulation writes it,
      and no position is sorted;
    * accumulate, otherwise: one accumulating ``index_put_``, which sums
      repeated coordinates in entry order.

    Both give the same band bit for bit where both apply (an explicit -0.0
    is stored as +0.0). The flag that picks the route is computed on the
    device before ``unique`` and copied to pinned host memory without a
    sync of its own: ``unique``'s host read completes the copy. The host
    spans ``sbtorch:csr_to_dia:offsets`` and ``:fill`` hold the two steps;
    the first ends in that host read. The counters ``csr_to_dia.scatter``
    and ``csr_to_dia.accumulate`` count the calls on each route."""
    n, m = csr.shape
    with host_span("sbtorch:csr_to_dia:offsets"):
        row = csr.row_of_nnz()
        off = csr.indices.to(torch.int32) - row.to(torch.int32)
        descends = _descent_in_a_row(off, csr.indptr)
        offsets = torch.unique(off)
    with host_span("sbtorch:csr_to_dia:fill"):
        dev = off.device
        if bool(descends):
            count("csr_to_dia.accumulate")
            d_idx = torch.searchsorted(offsets, off)
            vals = csr.vals
            if vals is None:
                vals = torch.ones((csr.nnz,), dtype=torch.float32, device=dev)
            data = torch.zeros((offsets.shape[0], n), dtype=vals.dtype, device=dev)
            data.index_put_((d_idx, row.long()), vals, accumulate=True)
            return DIA(offsets, data, (n, m))
        count("csr_to_dia.scatter")
        # each entry's cell, diagonal * n + row, in int64; the diagonal in
        # int32 (the sum then too) where no cell's position reaches 2^31
        d_idx = torch.searchsorted(offsets, off, out_int32=offsets.shape[0] * n < 2**31)
        del off
        pos = d_idx if d_idx.dtype == torch.int64 else torch.empty((csr.nnz,), dtype=torch.int64, device=dev)
        torch.add(row, d_idx, alpha=n, out=pos)
        del row, d_idx
        vals = csr.vals
        if vals is None:
            vals = torch.ones((csr.nnz,), dtype=torch.float32, device=dev)
        elif vals.is_floating_point() or vals.is_complex():
            vals = vals + 0  # -0.0 becomes +0.0, as in the accumulating sum
        data = torch.zeros((offsets.shape[0], n), dtype=vals.dtype, device=dev)
        data.view(-1)[pos] = vals
    return DIA(offsets, data, (n, m))


def _descent_in_a_row(off: torch.Tensor, indptr: torch.Tensor) -> torch.Tensor:
    """Whether some row's ``off`` (its column ids less the row) fails to
    strictly ascend, as a one-element bool tensor on the host. From a card,
    it is copied without waiting into pinned memory: read it only after a
    sync of the stream."""
    nnz = off.shape[0]
    if nnz < 2:
        return torch.zeros((), dtype=torch.bool)
    # descent[k]: entries k - 1 and k lie in one row and do not ascend;
    # indptr holds 0 and nnz, so both ends are cleared with the row starts
    descent = torch.empty((nnz + 1,), dtype=torch.bool, device=off.device)
    torch.le(off[1:], off[:-1], out=descent[1:nnz])
    descent.index_fill_(0, indptr.long(), False)
    flag = descent.any()
    if flag.device.type != "cuda":
        return flag
    host = torch.empty((), dtype=torch.bool, pin_memory=True)
    return host.copy_(flag, non_blocking=True)


def dia_to_csr(dia: DIA) -> CSR:
    """DIA → CSR on the band's device. The stored band is scanned densely;
    explicit zeros are dropped. Offsets ascend, so a row-major walk of the
    (row, diagonal) mask yields sorted columns without a sort."""
    n, m = dia.shape
    offs = dia.offsets.to(torch.int64)
    i = torch.arange(n, device=offs.device)
    j = i[None, :] + offs[:, None]
    ok = ((j >= 0) & (j < m) & (dia.data != 0)).T
    r, d = ok.nonzero(as_tuple=True)
    col = (r + offs[d]).to(torch.int32)
    vals = dia.data[d, r]
    return CSR(indptr_from_counts(ok.sum(dim=1)), col, vals, (n, m))


def indptr_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of per-row counts, as int64 offsets."""
    zero = torch.zeros((1,), dtype=torch.int64, device=counts.device)
    return torch.cat([zero, torch.cumsum(counts, dim=0, dtype=torch.int64)])
