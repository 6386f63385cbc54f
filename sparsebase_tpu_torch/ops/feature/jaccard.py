"""Per-entry Jaccard similarity weights.

Counterpart of ``sparsebase_tpu/ops/feature/jaccard.py`` (reference
``feature::JaccardWeights``, the reference library's only GPU kernel:
src/sparsebase/feature/jaccard_weights_cuda.cu:8-150). For every entry
(u, v), ``J = |N(u) & N(v)| / |N(u) | N(v)|``, a float32 ``DenseArray``
parallel to the CSR's entries. Every instance of an id of N(u) counts when
it is a member of N(v), and the union is ``deg u + deg v - inter``: with
duplicate entries that differs from a set intersection, as in the
reference. Self-loops are kept.

Routes: CPU tensors take ``native.jaccard`` (graphkit) where it builds,
else ``_jaccard_host``; a CUDA CSR takes kernel K6 whatever its size (the
JAX package's flat-expansion wall ``MAX_FLAT_EXPANSION`` and its host
fallback are TPU limits with no counterpart here). All three agree bit for
bit. A CSR with more columns than rows raises ``ValueError`` before any
route: a column id must name a row.
"""

from __future__ import annotations

import torch

from ...formats.array import DenseArray
from ...formats.csr import CSR
from ..kernels.common_neighbors import check_ids_name_rows, common_neighbors_plain
from .base import Feature


def _jaccard_host(csr: CSR) -> torch.Tensor:
    """The weights by torch ops on CPU tensors: K6's plain version."""
    return common_neighbors_plain(csr, "jaccard")


class JaccardWeights(Feature):
    def __init__(self):
        super().__init__("jaccard_weights")
        self.register((CSR,), self._impl)

    @staticmethod
    def _impl(formats, params) -> DenseArray:
        csr: CSR = formats[0]
        check_ids_name_rows(csr)  # before any route: graphkit would read past indptr
        if csr.indptr.device.type != "cpu":
            from .sparse_common import jaccard_weights_sparse_device

            return DenseArray(jaccard_weights_sparse_device(csr))
        from ... import native

        if native.available():
            return DenseArray(native.jaccard(csr.nrows, csr.indptr, csr.indices, csr.nnz))
        return DenseArray(_jaccard_host(csr))

    def get_jaccard_weights(self, fmt, context=None, convert_input=True):
        return self.execute(self.params, fmt, context=context, convert_input=convert_input)
