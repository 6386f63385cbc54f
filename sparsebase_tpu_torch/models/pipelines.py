"""The main path: COO → CSR → degree reorder → symmetric permutation → SpMV;
``rcm_pipeline``, the same with the RCM device route; and the
format-polymorphic ``spmv``.

Counterpart of ``sparsebase_tpu/models/pipelines.py`` in its default
formulation. Steps, on the device the COO lives on, each a hand-written
kernel on CUDA tensors (its plain version on CPU tensors):

* ``indptr``: kernel K3, one pass over the sorted rows
  (``convert.kernels.indptr_from_sorted_rows``);
* degree rank: kernel K5, a **stable** radix rank of the degrees, so ``ro``
  matches the reference order exactly (``ranks_from_sort_keys``);
* SpMV: kernel K2 on the *source* CSR (it gathers ``x[col]`` itself), then
  ``y[ro[i]] = y_old[i]``;
* relocation: kernel K4 moves each row as one block, relabels its columns
  through ``ro[col]`` and sorts them inside the row (``ops/permute.py``),
  so the permuted CSR equals ``permute_2d(csr, ro, ro)`` by construction.
"""

from __future__ import annotations

import torch

from ..convert.kernels import indptr_from_sorted_rows
from ..dispatch import Operation
from ..formats.coo import COO
from ..formats.csr import CSR
from ..formats.dia import DIA
from ..formats.ell import ELL
from ..ops.kernels.banded_spmv import banded_spmv
from ..ops.kernels.csr_spmv import csr_spmv
from ..ops.permute import PermuteOrderTwoParams, _permute_csr
from ..ops.reorder.base import ranks_from_sort_keys


def spmv_csr(csr: CSR, x: torch.Tensor) -> torch.Tensor:
    """Row-wise SpMV (kernel K2 on CUDA, its plain version on the CPU)."""
    return csr_spmv(csr, x)


def _permute_and_spmv(coo: COO, indptr: torch.Tensor, ro: torch.Tensor, x: torch.Tensor):
    """Shared pipeline tail: given the inverse permutation ``ro`` and the
    CSR structure of the input, return the symmetrically permuted CSR and
    ``y = P·(A@x)``."""
    csr = CSR(indptr, coo.col, coo.vals, coo.shape)
    y_old = spmv_csr(csr, x)
    y = torch.empty_like(y_old)
    y[ro] = y_old  # y[ro[i]] = (A@x)[i]
    permuted = _permute_csr((csr,), PermuteOrderTwoParams(ro, ro))
    return permuted, y


def preprocess_pipeline(coo: COO, x: torch.Tensor):
    """COO → CSR → degree reorder → symmetric row/col permutation → SpMV.

    Returns ``(permuted_csr, y)`` with ``y = P·(A@x)``, the permuted
    matrix applied to the permuted vector. The COO must be square and
    row-major sorted (its invariant)."""
    n, m = coo.shape
    if n != m:
        raise ValueError(f"preprocess_pipeline permutes rows and columns alike; shape {coo.shape} is not square")
    indptr = indptr_from_sorted_rows(coo.row, n)
    # ro[old] = new. A degree is at most nnz: K5 plans only the bytes nnz has.
    ro = ranks_from_sort_keys(indptr[1:] - indptr[:-1], key_bits=coo.nnz.bit_length())
    return _permute_and_spmv(coo, indptr, ro, x)


def rcm_pipeline(coo: COO, x: torch.Tensor):
    """COO → CSR (K3) → the RCM device route on that CSR's out-edges →
    symmetric permutation (K4) → SpMV (K2), on the COO's device: the
    reference's ``examples/rcm_order`` and tutorial 004 as one call.
    Returns ``(permuted_csr, y)`` with ``y = P·(A@x)``; the COO must be
    square and row-major sorted."""
    from ..ops.reorder.rcm import _rcm_device

    n, m = coo.shape
    if n != m:
        raise ValueError(f"rcm_pipeline permutes rows and columns alike; shape {coo.shape} is not square")
    indptr = indptr_from_sorted_rows(coo.row, n)
    ro = _rcm_device(CSR(indptr, coo.col, coo.vals, coo.shape))
    return _permute_and_spmv(coo, indptr, ro, x)


def spmv_ell(ell: ELL, x: torch.Tensor) -> torch.Tensor:
    """Row-wise SpMV on the ELL layout: masked products and a row sum, as
    torch ops; a pattern matrix multiplies by its mask."""
    mask = ell.valid_mask()
    xg = x[ell.cols.long()]
    prod = xg if ell.vals is None else ell.vals * xg
    return torch.where(mask, prod, torch.zeros_like(prod)).sum(dim=1)


_SPMV = Operation("spmv")
_SPMV.register((CSR,), lambda f, x: spmv_csr(f[0], x))
_SPMV.register((ELL,), lambda f, x: spmv_ell(f[0], x))
_SPMV.register((DIA,), lambda f, x: banded_spmv(f[0], x))


def spmv(fmt, x: torch.Tensor, context=None) -> torch.Tensor:
    """Format-polymorphic SpMV with auto-conversion dispatch: CSR runs
    kernel K2, ELL its masked row sums, DIA kernel K1, and any other format
    (COO, CSC, ...) converts through the conversion graph first (the
    reference's FunctionMatcherMixin dispatch,
    function_matcher_mixin.h:335-416)."""
    return _SPMV.execute(x, fmt, context=context)
