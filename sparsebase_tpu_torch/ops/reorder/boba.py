"""BOBA reordering ("Batched Order By Attachment").

Counterpart of ``sparsebase_tpu/ops/reorder/boba.py`` (reference
``reorder::BOBAReorder``, src/sparsebase/reorder/boba_reorder.cc:33-160;
params boba_reorder.h:13-18). The entries are sorted by (col, row); the
vertices are emitted by first appearance in the sequence ``rows of the
sorted entries ++ their cols``; isolated vertices follow in id order. The
reference's sequential and OpenMP variants give the same order, so
``sequential`` is accepted and has no effect.

Three steps on the COO's own device, none of which reads back to the host:

* the (col, row) order from one stable sort of packed pairs
  (``sort_by_pairs``: kernel K5 on CUDA tensors). The JAX package takes two
  stable argsorts, and its device pair sort is unstable among duplicate
  pairs; neither matters, since duplicates carry the same row and column;
* each vertex's first appearance by a scatter-min (``scatter_reduce_``,
  ``"amin"``) in int64, ``2 * nnz + n`` for a vertex that never appears;
* the order from one stable sort of those first appearances (K5 on CUDA
  tensors), whose ties are the isolated vertices alone, kept in id order.
"""

from __future__ import annotations

import dataclasses

import torch

from ...convert.kernels import sort_by_pairs
from ...formats.coo import COO
from ..kernels.radix import bits_below
from .base import Reorderer, ranks_from_sort_keys


@dataclasses.dataclass
class BOBAReorderParams:
    sequential: bool = False


def _boba_impl(formats, params: BOBAReorderParams) -> torch.Tensor:
    coo: COO = formats[0]
    nnz = coo.nnz
    n = max(coo.nrows, coo.ncols)
    dev = coo.row.device
    # entries by (col, row) (boba_reorder.cc:64-67)
    col, row = sort_by_pairs(coo.col, coo.row, major_bound=coo.ncols, minor_bound=coo.nrows)
    never = 2 * nnz + n
    first = torch.full((n,), never, dtype=torch.int64, device=dev)
    pos = torch.arange(nnz, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, row.long(), pos, "amin")  # the sequence's first half: rows
    first.scatter_reduce_(0, col.long(), pos + nnz, "amin")  # its second half: cols
    return ranks_from_sort_keys(first, key_bits=bits_below(never + 1))


class BOBAReorder(Reorderer):
    def __init__(self, sequential: bool = False):
        super().__init__("boba_reorder")
        self.params = BOBAReorderParams(sequential)
        self.register((COO,), _boba_impl)
