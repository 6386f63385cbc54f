"""Permutation ops: apply inverse permutations to formats.

Counterpart of ``sparsebase_tpu/ops/permute.py`` (reference
src/sparsebase/permute/permuter.h:22-52, permute_order_two.cc:30-95).
Permutations follow the reference convention ``order[old_id] = new_id``
(reorder/reorderer.h:49-52).

A symmetric CSR permutation relabels each entry's row (expanded from the
row table over the row blocks) and column (one gather), then re-sorts with
one stable sort of the packed (row, col) key; the new ``indptr`` is the old
degrees scattered through the row order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..convert.kernels import expand_row_table, indptr_from_counts, sort_by_pairs
from ..dispatch import Operation
from ..formats.coo import COO
from ..formats.csr import CSR


def inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    """perm⁻¹: if ``order[old] = new``, returns ``inv`` with ``inv[new] = old``
    (``ReorderBase::InversePermutation``, bases/reorder_base.h)."""
    return torch.argsort(order).to(order.dtype)


@dataclasses.dataclass
class PermuteOrderTwoParams:
    """``row_order`` / ``col_order`` are inverse permutations (int tensors on
    the format's device); None is the identity (permute_order_two.h:12-18)."""

    row_order: Optional[torch.Tensor] = None
    col_order: Optional[torch.Tensor] = None


def _permute_csr(formats, params: PermuteOrderTwoParams) -> CSR:
    csr: CSR = formats[0]
    idt = csr.indices.dtype
    degrees = csr.degrees()
    if params.row_order is None:
        new_row = csr.row_of_nnz()
        counts = degrees
    else:
        ro = params.row_order
        new_row = expand_row_table(ro.to(idt), csr.indptr, csr.nnz)
        counts = torch.empty_like(degrees)
        counts[ro] = degrees  # ro is a bijection: every slot is written once
    new_col = csr.indices
    if params.col_order is not None:
        new_col = params.col_order.to(idt)[csr.indices]
    _, col_s, vals_s = sort_by_pairs(new_row, new_col, csr.vals)
    return CSR(indptr_from_counts(counts), col_s, vals_s, csr.shape)


def _permute_coo(formats, params: PermuteOrderTwoParams) -> COO:
    coo: COO = formats[0]
    row = coo.row if params.row_order is None else params.row_order.to(coo.row.dtype)[coo.row]
    col = coo.col if params.col_order is None else params.col_order.to(coo.col.dtype)[coo.col]
    return COO(row, col, coo.vals, coo.shape).sort_rowmajor()


class PermuteOrderTwo(Operation):
    """Parity: ``permute::PermuteOrderTwo`` (permute_order_two.cc)."""

    def __init__(self, row_order=None, col_order=None):
        super().__init__("permute_order_two")
        self.params = PermuteOrderTwoParams(row_order, col_order)
        self.register((CSR,), _permute_csr)
        self.register((COO,), _permute_coo)

    def get_permutation(self, fmt, context=None, convert_input: bool = True):
        return self.execute(self.params, fmt, context=context, convert_input=convert_input)

    def get_permutation_cached(self, fmt, context=None, convert_input: bool = True):
        return self.execute_cached(
            self.params, fmt, context=context, convert_input=convert_input
        )


def permute_2d(fmt, row_order=None, col_order=None, context=None):
    """Functional one-shot 2-D permutation."""
    return PermuteOrderTwo(row_order, col_order).get_permutation(fmt, context)
