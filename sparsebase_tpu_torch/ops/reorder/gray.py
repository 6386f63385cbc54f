"""Gray-code reordering.

Counterpart of ``sparsebase_tpu/ops/reorder/gray.py`` (reference
``reorder::GrayReorder``, src/sparsebase/reorder/gray_reorder.cc; params
gray_reorder.h:13-28), with its semantics:

* rows split into sparse and dense by ``nnz_threshold``
  (gray_reorder.cc:149-170);
* bandedness: the sparse rows are "banded" if more than 30% of their
  entries lie within ``ncols // 128`` of the diagonal, and then keep plain
  degree order; the dense rows if more than 20%, and then keep their id
  order (gray_reorder.cc:178-190);
* each row's occupancy bitmap over ``res = min(resolution, ncols)`` column
  blocks, bit j set when block j holds more entries than a threshold (0 for
  sparse rows, ``degree // res`` for dense rows); the sort key is the
  Gray-decoded bitmap (``grey_bin_to_dec``, a suffix XOR), its first 62
  bits;
* sparse rows: chunks of ``sparse_density_group_size`` distinct non-zero
  degrees, sorted by key in alternating directions, empty rows first in id
  order (gray_reorder.cc:283-330); dense rows: one ascending key sort
  (gray_reorder.cc:371-407).

Everything runs on the CSR's own device, with no read back to the host:

* the (row, block) histogram is an int32 ``scatter_add_`` into an (n, res)
  grid (integer adds are exact, in any order); the suffix parity, which
  the JAX package takes by a flip, ``cumsum`` and ``% 2`` over the grid, is
  six shift-XOR steps on each row's packed word (on the card a cumsum along
  rows of 32 cells is slow: PERF.md, path G);
* the distinct-degree groups come from a stable sort of the degrees (K5)
  and a count of their changes;
* the band tests are exact integer comparisons, ``10 * a > 3 * b`` and
  ``5 * a > b`` for a share ``a / b``, kept on the device with
  ``torch.where``. They equal the JAX host route's float64 ``a / b > 0.3``
  for every count below 10^15;
* the JAX package's five-key ``lexsort((ids, low, high, chunk, part))``
  becomes two stable sorts (kernel K5 on CUDA tensors): first by the Gray
  key, then, through that order, by ``(part << B) | (chunk + 1)``;
  stability gives the id tie-break. Inside one (part, chunk) class every row
  is sorted the same way round, so an odd chunk's descending order is taken
  as ``(2**r - 1) - key`` over the key's ``r = min(res, 62)`` bits, where
  the JAX package inverts two 31-bit words: the same order in fewer digits.
"""

from __future__ import annotations

import dataclasses

import torch

from ...formats.csr import CSR
from ..kernels.radix import bits_below, radix_argsort
from .base import Reorderer, ranks_from_sort_keys

KEY_BITS = 62  # the decoded bitmap's bits that the key keeps (two 31-bit words in the JAX package)


@dataclasses.dataclass
class GrayReorderParams:
    resolution: int = 32  # bitmap width (16/32/64)
    nnz_threshold: int = 8
    sparse_density_group_size: int = 8


def _gray_keys(csr: CSR, row: torch.Tensor, res: int, per_row_threshold: torch.Tensor) -> torch.Tensor:
    """Each row's Gray-decoded occupancy bitmap over ``res`` column blocks,
    its bits below ``KEY_BITS`` packed into an int64 (bit j has weight 2^j);
    ``row`` is each entry's row id (int64)."""
    n, ncols = csr.shape
    dev = csr.indptr.device
    row_split = max(ncols // res, 1)
    block = torch.clamp(csr.indices.to(torch.int64) // row_split, max=res - 1)
    counts = torch.zeros((n * res,), dtype=torch.int32, device=dev)
    counts.scatter_add_(0, row * res + block, torch.ones((csr.nnz,), dtype=torch.int32, device=dev))
    del block
    bits = counts.view(n, res) > per_row_threshold[:, None]  # bit j: block j occupied
    del counts
    # Gray decode: decoded bit j = XOR of the Gray bits k >= j, a suffix
    # parity. Within the packed word that is g ^ g >> 1 ^ g >> 2 ^ ..., six
    # shift-XOR steps; the bits at or past KEY_BITS flip every kept bit when
    # their parity is odd
    r = min(res, KEY_BITS)
    j = torch.arange(r, device=dev)
    key = (bits[:, :r].to(torch.int64) << j).sum(dim=1)
    for shift in (1, 2, 4, 8, 16, 32):
        key ^= key >> shift
    if res > KEY_BITS:
        odd = bits[:, KEY_BITS:].sum(dim=1) % 2
        key ^= odd * ((1 << r) - 1)
    return key


def _banded_counts(in_rows: torch.Tensor, in_band: torch.Tensor):
    """``(a, b)`` of the share ``a / b`` of the entries in ``in_rows`` that
    are ``in_band``, as 0-d int64 tensors; ``b`` is at least 1."""
    return (in_rows & in_band).sum(), torch.clamp(in_rows.sum(), min=1)


def _dense_rank(values: torch.Tensor, key_bits: int) -> torch.Tensor:
    """The rank of each value among the sorted distinct values (int64), from
    one stable sort of values in ``[0, 2**key_bits)`` (K5 on CUDA tensors)
    and a count of the value changes; no read back to the host, where
    ``torch.unique`` would read its output's size."""
    perm = radix_argsort(values, key_bits=key_bits).long()
    ordered = values[perm]
    change = torch.ones_like(ordered, dtype=torch.bool)
    change[1:] = ordered[1:] != ordered[:-1]
    rank = torch.empty_like(perm)
    rank[perm] = torch.cumsum(change, 0) - 1
    return rank


def _gray_impl(formats, params: GrayReorderParams) -> torch.Tensor:
    csr: CSR = formats[0]
    n, ncols = csr.shape
    dev = csr.indptr.device
    if n == 0:
        return torch.empty((0,), dtype=torch.int32, device=dev)
    degrees = csr.degrees().to(torch.int64)
    sparse_mask = degrees <= params.nnz_threshold

    row = csr.row_of_nnz().to(torch.int64)
    in_band = (csr.indices.to(torch.int64) - row).abs() <= max(ncols // 128, 1)
    sparse_entry = sparse_mask[row]
    a, b = _banded_counts(sparse_entry, in_band)
    sparse_banded = 10 * a > 3 * b  # share > 0.3
    a, b = _banded_counts(~sparse_entry, in_band)
    dense_banded = 5 * a > b  # share > 0.2
    del in_band, sparse_entry

    res = min(params.resolution, ncols)
    r = min(res, KEY_BITS)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    key = _gray_keys(csr, row, res, torch.where(sparse_mask, 0, degrees // res))
    del row

    # sparse rows: chunks of distinct non-zero degrees, alternating direction;
    # empty rows are no group and stay first in id order
    group = _dense_rank(degrees, csr.nnz.bit_length())  # a degree is at most nnz
    has_empty = (degrees == 0).any()
    group = torch.where(degrees > 0, group - has_empty.to(group.dtype), -1)
    chunk = torch.where(group >= 0, group // max(params.sparse_density_group_size, 1), -1)
    odd = (chunk % 2 == 1) & (chunk >= 0)
    s_key = torch.where(odd, ((1 << r) - 1) - key, key)
    s_key = torch.where(chunk < 0, zero, s_key)
    s_key = torch.where(sparse_banded, zero, s_key)  # banded: plain degree order
    s_chunk = torch.where(sparse_banded, group, chunk)
    # dense rows: ascending key, or id order when banded
    d_key = torch.where(dense_banded, zero, key)

    # the lexsort by (part, chunk, key, id): key first, then (part, chunk + 1)
    # through that order; chunk + 1 lies in [0, n]
    chunk_bits = bits_below(n + 1)
    key = torch.where(sparse_mask, s_key, d_key)
    major = ((~sparse_mask).to(torch.int64) << chunk_bits) | (torch.where(sparse_mask, s_chunk, 0) + 1)
    by_key = radix_argsort(key, key_bits=r).long()
    rank = ranks_from_sort_keys(major[by_key], key_bits=chunk_bits + 1)
    order = torch.empty((n,), dtype=torch.int32, device=dev)
    order[by_key] = rank
    return order


class GrayReorder(Reorderer):
    def __init__(self, resolution: int = 32, nnz_threshold: int = 8, sparse_density_group_size: int = 8):
        super().__init__("gray_reorder")
        self.params = GrayReorderParams(resolution, nnz_threshold, sparse_density_group_size)
        self.register((CSR,), _gray_impl)
