"""The main path: COO → CSR → degree reorder → symmetric permutation → SpMV;
``rcm_pipeline``, the same with the RCM device route; ``partition_pipeline``,
the same with the rows grouped by a label-propagation partition; and the
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

Each pipeline call runs in the span ``sbtorch:pipeline:<name>``, and each
step in a span ``sbtorch:stage:<step>`` inside it (``utils/tracing.py``).
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
from ..ops.kernels.csr_spmv import check_real, csr_spmv
from ..ops.permute import PermuteOrderTwoParams, _permute_csr
from ..ops.reorder.base import ranks_from_sort_keys
from ..utils.tracing import span


def spmv_csr(csr: CSR, x: torch.Tensor, method: str = "auto") -> torch.Tensor:
    """Row-wise SpMV (``sparsebase_tpu/models/pipelines.py:40-62``).

    ``method``:
      * ``"auto"`` and ``"segment"``: exact per-row sums, kernel K2 on CUDA
        tensors, its plain version on CPU tensors;
      * ``"cumsum"``: the JAX package's device formulation as torch ops, an
        inclusive prefix sum of the products read off at the ``indptr``
        boundaries; its rounding grows like O(eps·sqrt(nnz)·|v|) with the
        running sum. For parity with that package, not for speed.
    A complex matrix or ``x`` raises ``TypeMismatchError``."""
    if method in ("auto", "segment"):
        return csr_spmv(csr, x)
    if method != "cumsum":
        raise ValueError(f"spmv_csr: unknown method {method!r}; one of 'auto', 'segment', 'cumsum'")
    check_real(csr, x)
    prod = x[csr.indices.long()]
    if csr.vals is not None:
        prod = csr.vals.to(x.dtype) * prod
    run = torch.cat([torch.zeros((1,), dtype=prod.dtype, device=prod.device), torch.cumsum(prod, 0)])
    return run[csr.indptr[1:].long()] - run[csr.indptr[:-1].long()]


def _permute_and_spmv(coo: COO, indptr: torch.Tensor, ro: torch.Tensor, x: torch.Tensor):
    """Shared pipeline tail: given the inverse permutation ``ro`` and the
    CSR structure of the input, return the symmetrically permuted CSR and
    ``y = P·(A@x)``."""
    csr = CSR(indptr, coo.col, coo.vals, coo.shape)
    with span("sbtorch:stage:spmv"):
        y_old = spmv_csr(csr, x)
        y = torch.empty_like(y_old)
        y[ro] = y_old  # y[ro[i]] = (A@x)[i]
    with span("sbtorch:stage:permute"):
        permuted = _permute_csr((csr,), PermuteOrderTwoParams(ro, ro))
    return permuted, y


def preprocess_pipeline(coo: COO, x: torch.Tensor):
    """COO → CSR → degree reorder → symmetric row/col permutation → SpMV.

    Returns ``(permuted_csr, y)`` with ``y = P·(A@x)``, the permuted
    matrix applied to the permuted vector. The COO must be square and
    row-major sorted (its invariant)."""
    with span("sbtorch:pipeline:preprocess"):
        return _preprocess(coo, x, donate=False)


def preprocess_pipeline_donating(coo: COO, x: torch.Tensor):
    """:func:`preprocess_pipeline` that consumes its COO (the JAX package's
    donation, ``sparsebase_tpu/models/pipelines.py:326-332``; the
    reference's move conversions, converter_order_two.cc:258-341). The COO
    lets go of each of its tensors as soon as the pipeline's last reader of
    it has run: ``coo.row`` right after K3 has built ``indptr``, which lowers
    the peak by up to 4·nnz bytes (int32 ids) where the COO held the last
    reference; ``coo.col`` and ``coo.vals``, which K2 and K4 read, at the
    end. A later use of the COO raises. The tensors are dropped, not their
    storage resized to 0: a tensor over freed storage would fault on its
    next use (a segmentation fault on the CPU, an illegal address that ends
    the CUDA context on the card), and storage that another tensor shares
    (``x``, a view) must stay."""
    with span("sbtorch:pipeline:preprocess"):
        return _preprocess(coo, x, donate=True)


class _Consumed:
    """Stands in for a tensor of a COO that ``preprocess_pipeline_donating``
    consumed: any use raises."""

    def __getattr__(self, name):
        raise RuntimeError("this COO was consumed by preprocess_pipeline_donating; its tensors are gone")

    def __repr__(self) -> str:
        return "<consumed by preprocess_pipeline_donating>"


_CONSUMED = _Consumed()


def _drop(coo: COO, *names: str) -> None:
    for name in names:
        object.__setattr__(coo, name, _CONSUMED)  # COO is frozen to its users, not to its consumer


def _preprocess(coo: COO, x: torch.Tensor, donate: bool):
    n, m = coo.shape
    if n != m:
        raise ValueError(f"preprocess_pipeline permutes rows and columns alike; shape {coo.shape} is not square")
    nnz = coo.nnz
    with span("sbtorch:stage:indptr"):
        indptr = indptr_from_sorted_rows(coo.row, n)
    if donate:
        _drop(coo, "row")
    # ro[old] = new. A degree is at most nnz: K5 plans only the bytes nnz has.
    with span("sbtorch:stage:rank"):
        ro = ranks_from_sort_keys(indptr[1:] - indptr[:-1], key_bits=nnz.bit_length())
    permuted, y = _permute_and_spmv(coo, indptr, ro, x)
    if donate:
        _drop(coo, "col", "vals")
    return permuted, y


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
    with span("sbtorch:pipeline:rcm"):
        with span("sbtorch:stage:indptr"):
            indptr = indptr_from_sorted_rows(coo.row, n)
        with span("sbtorch:stage:rcm"):
            ro = _rcm_device(CSR(indptr, coo.col, coo.vals, coo.shape))
        return _permute_and_spmv(coo, indptr, ro, x)


def partition_pipeline(coo: COO, x: torch.Tensor, k: int = 8, num_iters: int = 10):
    """COO → CSR (K3) → ``num_iters`` rounds of label propagation into ``k``
    parts (K7 each) → rows grouped by part, in id order within a part (a
    stable K5 rank of the labels) → symmetric permutation (K4) → SpMV (K2),
    on the COO's device with no host read: the reference's
    ``examples/metis_partition`` followed by a permute, as one call
    (``sparsebase_tpu/models/pipelines.py:302-324``). The rounds start from
    ``k`` contiguous chunks, with a capacity of ``1.1 n / k``, and all run,
    as in the JAX package's device route. Returns ``(permuted_csr, y,
    labels)`` with ``y = P·(A@x)`` and int32 ``labels``; the COO must be
    square and row-major sorted."""
    from ..ops.kernels.radix import bits_below
    from ..ops.partition.labelprop import _chunks, _propagate

    n, m = coo.shape
    if n != m:
        raise ValueError(f"partition_pipeline permutes rows and columns alike; shape {coo.shape} is not square")
    with span("sbtorch:pipeline:partition"):
        with span("sbtorch:stage:indptr"):
            indptr = indptr_from_sorted_rows(coo.row, n)
        csr = CSR(indptr, coo.col, coo.vals, coo.shape)
        with span("sbtorch:stage:label_prop"):
            labels = _propagate(csr, _chunks(n, k, indptr.device), k, 1.1 * n / k, None, num_iters,
                                stop_when_stable=False)
        with span("sbtorch:stage:rank"):
            ro = ranks_from_sort_keys(labels, key_bits=bits_below(k))  # ro[old] = new, stable within a part
        permuted, y = _permute_and_spmv(coo, indptr, ro, x)
    return permuted, y, labels


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
