"""Permutation ops: apply inverse permutations to formats.

Counterpart of ``sparsebase_tpu/ops/permute.py`` (reference
src/sparsebase/permute/permuter.h:22-52, permute_order_two.cc:30-95).
Permutations follow the reference convention ``order[old_id] = new_id``
(reorder/reorderer.h:49-52).

A CSR permutation is one relocation (kernel K4, ``ops/kernels/relocate.py``):
each old row moves as one block to its new row, its columns relabelled and
sorted inside the row; the new ``indptr`` is the old degrees scattered
through the row order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..dispatch import Operation
from ..formats.coo import COO
from ..formats.csr import CSR
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
