"""Permutation ops: apply inverse permutations to formats.

Counterpart of ``sparsebase_tpu/ops/permute.py`` (reference
src/sparsebase/permute/permuter.h:22-52, permute_order_two.cc:30-95).
Permutations follow the reference convention ``order[old_id] = new_id``
(reorder/reorderer.h:49-52).

A CSR permutation is one relocation (kernel K4, ``ops/kernels/relocate.py``):
each old row moves as one block to its new row, its columns relabelled and
sorted inside the row; the new ``indptr`` is the old degrees scattered
through the row order. An ELL permutation relabels the valid slots'
columns, sorts each row, and moves the rows with one gather; a dense array
is permuted by one scatter (``permute_order_one.cc``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..dispatch import Operation
from ..formats.array import DenseArray
from ..formats.coo import COO
from ..formats.csr import CSR
from ..formats.ell import ELL
from .kernels.relocate import relocate_csr


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
    return relocate_csr(formats[0], params.row_order, params.col_order)


def _permute_coo(formats, params: PermuteOrderTwoParams) -> COO:
    coo: COO = formats[0]
    row = coo.row if params.row_order is None else params.row_order.to(coo.row.dtype)[coo.row]
    col = coo.col if params.col_order is None else params.col_order.to(coo.col.dtype)[coo.col]
    return COO(row, col, coo.vals, coo.shape).sort_rowmajor()


def _permute_ell(formats, params: PermuteOrderTwoParams) -> ELL:
    ell: ELL = formats[0]
    if params.col_order is not None:
        relabelled = params.col_order.to(ell.cols.dtype)[ell.cols.long()]
        cols = torch.where(ell.valid_mask(), relabelled, torch.zeros_like(relabelled))
        ell = dataclasses.replace(ell, cols=cols).sort_rows()
    if params.row_order is not None:
        ell = ell.permute_rows(params.row_order)
    return ell


class PermuteOrderTwo(Operation):
    """Parity: ``permute::PermuteOrderTwo`` (permute_order_two.cc)."""

    def __init__(self, row_order=None, col_order=None):
        super().__init__("permute_order_two")
        self.params = PermuteOrderTwoParams(row_order, col_order)
        self.register((CSR,), _permute_csr)
        self.register((COO,), _permute_coo)
        self.register((ELL,), _permute_ell)

    def get_permutation(self, fmt, context=None, convert_input: bool = True):
        return self.execute(self.params, fmt, context=context, convert_input=convert_input)

    def get_permutation_cached(self, fmt, context=None, convert_input: bool = True):
        return self.execute_cached(
            self.params, fmt, context=context, convert_input=convert_input
        )


def _permute_array(formats, order: torch.Tensor) -> DenseArray:
    vals = formats[0].vals
    out = torch.empty_like(vals)
    out[order.long()] = vals  # out[order[i]] = vals[i]
    return DenseArray(out)


class PermuteOrderOne(Operation):
    """Parity: ``permute::PermuteOrderOne`` (permute_order_one.cc)."""

    def __init__(self, order):
        super().__init__("permute_order_one")
        self.params = order
        self.register((DenseArray,), _permute_array)

    def get_permutation(self, fmt, context=None, convert_input: bool = True):
        return self.execute(self.params, fmt, context=context, convert_input=convert_input)


def permute_2d(fmt, row_order=None, col_order=None, context=None):
    """Functional one-shot 2-D permutation."""
    return PermuteOrderTwo(row_order, col_order).get_permutation(fmt, context)


def permute_1d(arr, order, context=None):
    """Functional one-shot 1-D permutation."""
    return PermuteOrderOne(order).get_permutation(arr, context)
