"""Compressed Sparse Column format.

Counterpart of ``sparsebase_tpu/formats/csc.py`` (reference
src/sparsebase/format/csc.h:28-, csc.cc). Columns are delimited by
``indptr`` (int64); row ids (int32) are sorted within each column. As in
the JAX package, CSC is a full node of the conversion graph: CSC→COO and
CSC→CSR are registered beside COO→CSC and CSR→CSC (``convert/kernels.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..utils.typing import convert_array_dtype
from .base import Format, register_format


@register_format
@dataclasses.dataclass(frozen=True)
class CSC(Format):
    """Order-2 sparse matrix in CSC layout; ``vals is None`` is a pattern
    matrix."""

    indptr: torch.Tensor  # (ncols+1,) int64
    indices: torch.Tensor  # (nnz,) int32 row ids, sorted within each column
    vals: Optional[torch.Tensor]  # (nnz,) or None
    _shape: Tuple[int, int] = (0, 0)

    order = 2

    @staticmethod
    def new(indptr, indices, vals=None, shape=None) -> "CSC":
        if shape is None:
            shape = (int(indices.max()) + 1 if indices.numel() else 0, int(indptr.shape[0]) - 1)
        return CSC(indptr, indices, vals, (int(shape[0]), int(shape[1])))

    @property
    def shape(self) -> Tuple[int, int]:
        return self._shape

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def nrows(self) -> int:
        return self._shape[0]

    @property
    def ncols(self) -> int:
        return self._shape[1]

    @property
    def id_dtype(self):
        return self.indices.dtype

    @property
    def nnz_dtype(self):
        return self.indptr.dtype

    @property
    def value_dtype(self):
        return None if self.vals is None else self.vals.dtype

    def col_of_nnz(self) -> torch.Tensor:
        """Per-entry column id, as ``indices.dtype``."""
        cols = torch.arange(self.ncols, dtype=self.indices.dtype, device=self.indptr.device)
        return torch.repeat_interleave(cols, self.indptr[1:] - self.indptr[:-1], output_size=self.nnz)

    def astype(self, id_dtype=None, nnz_dtype=None, value_dtype=None) -> "CSC":
        return dataclasses.replace(
            self,
            indptr=convert_array_dtype(self.indptr, nnz_dtype) if nnz_dtype else self.indptr,
            indices=convert_array_dtype(self.indices, id_dtype) if id_dtype else self.indices,
            vals=(
                convert_array_dtype(self.vals, value_dtype)
                if (value_dtype and self.vals is not None)
                else self.vals
            ),
        )

    def to_dense(self) -> torch.Tensor:
        vals = self.vals
        if vals is None:
            vals = torch.ones((self.nnz,), dtype=torch.int8, device=self.indices.device)
        dense = torch.zeros(self._shape, dtype=vals.dtype, device=vals.device)
        dense.index_put_((self.indices.long(), self.col_of_nnz().long()), vals, accumulate=True)
        return dense

    def __repr__(self) -> str:
        return f"CSC(shape={self._shape}, nnz={self.nnz}, context={self.context!r})"
