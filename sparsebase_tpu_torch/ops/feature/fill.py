"""Symbolic-factorisation fill: nnz(L) of the Cholesky factor.

Counterpart of ``sparsebase_tpu/ops/feature/fill.py``: the fill metric an
AMD order is judged on (the reference's AMD delivers SuiteSparse orderings,
src/sparsebase/reorder/amd_reorder.cc:29-57). ``nnz(L)`` of the symmetrised
pattern in its current order, counted exactly by the elimination-tree walk:
for row i, each lower entry k climbs the partly built tree until it meets a
row already marked for i; the work is O(nnz(L)). The walk is sequential by
nature, so both packages run it on the host: ``native.fill_in`` (graphkit)
where it builds, else ``_fill_nnz_host``. A CUDA CSR is copied to the host.

To score an ordering, permute first (``ReorderBase.permute2d``) and take the
fill of the permuted matrix.
"""

from __future__ import annotations

import dataclasses

import torch

from ...formats.csr import CSR
from .base import Feature


@dataclasses.dataclass
class FillInParams:
    pass


def _fill_nnz_host(indptr: torch.Tensor, indices: torch.Tensor, n: int) -> int:
    """nnz(L), the diagonal included, of the symmetrised pattern in natural
    order: a Python walk over lists built from the CPU tensors."""
    rows = torch.repeat_interleave(torch.arange(n, dtype=torch.int64), indptr[1:] - indptr[:-1])
    cols = indices.to(torch.int64)
    lo_r, lo_c = torch.cat([rows, cols]), torch.cat([cols, rows])
    keep = lo_c < lo_r  # strictly lower entries of A + A^T
    lo_r, lo_c = lo_r[keep], lo_c[keep]
    order = torch.argsort(lo_r * max(n, 1) + lo_c, stable=True)
    lo_r, lo_c = lo_r[order], lo_c[order]
    starts = [0] + torch.cumsum(torch.bincount(lo_r, minlength=n), 0).tolist()
    lower = lo_c.tolist()
    parent, mark = [-1] * n, [-1] * n
    count = n  # the diagonal
    for i in range(n):
        mark[i] = i
        for k in lower[starts[i]:starts[i + 1]]:
            while mark[k] != i:  # climb the tree, marking the new entries of L's row i
                if parent[k] == -1:
                    parent[k] = i
                mark[k] = i
                count += 1
                k = parent[k]
    return count


class FillIn(Feature):
    """``nnz(L)`` of the symbolic Cholesky factor of the symmetrised pattern
    in its current row order; duplicate entries count once."""

    def __init__(self):
        super().__init__("fill_in")
        self.params = FillInParams()
        self.register((CSR,), self._impl)

    @staticmethod
    def _impl(formats, params) -> int:
        csr: CSR = formats[0].to_host()
        from ... import native

        indptr, indices = csr.indptr.to(torch.int64), csr.indices.to(torch.int64)
        if native.available():
            return native.fill_in(csr.nrows, indptr, indices)
        return _fill_nnz_host(indptr, indices, csr.nrows)

    def get_fill_in(self, fmt, context=None, convert_input=True):
        return self.execute(self.params, fmt, context=context, convert_input=convert_input)

    get_fill = get_fill_in
