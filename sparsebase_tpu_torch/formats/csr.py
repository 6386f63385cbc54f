"""Compressed Sparse Row format.

Counterpart of ``sparsebase_tpu/formats/csr.py`` (reference
src/sparsebase/format/csr.h:27-60, csr.cc). Rows are delimited by
``indptr`` (int64: offsets may pass 2^31); column ids (int32) are sorted
within each row, which :func:`CSR.new` checks and repairs like the
reference constructor (csr.cc:99-158).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..utils.logger import Logger
from ..utils.typing import convert_array_dtype
from .base import Format, register_format

_log = Logger("CSR")


@register_format
@dataclasses.dataclass(frozen=True)
class CSR(Format):
    """Order-2 sparse matrix in CSR layout; ``vals is None`` is a pattern
    matrix (reference ``ValueType=void``)."""

    indptr: torch.Tensor  # (nrows+1,) int64
    indices: torch.Tensor  # (nnz,) int32, sorted within each row
    vals: Optional[torch.Tensor]  # (nnz,) or None
    _shape: Tuple[int, int] = (0, 0)

    order = 2

    @staticmethod
    def new(indptr, indices, vals=None, shape=None, *, sort: bool = True) -> "CSR":
        """Build a CSR, checking/repairing the per-row column sort
        (csr.cc:99-158); ``sort=False`` skips it (``ignore_sort``)."""
        if shape is None:
            shape = (
                int(indptr.shape[0]) - 1,
                int(indices.max()) + 1 if indices.numel() else 0,
            )
        csr = CSR(indptr, indices, vals, (int(shape[0]), int(shape[1])))
        if sort and not csr.is_sorted():
            _log.warning("CSR column array not sorted within rows; sorting.")
            csr = csr.sort_rows()
        return csr

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

    def degrees(self) -> torch.Tensor:
        """Entries per row (int64)."""
        return self.indptr[1:] - self.indptr[:-1]

    def row_of_nnz(self) -> torch.Tensor:
        """Per-entry row id (the CSR→COO row vector), as ``indices.dtype``."""
        rows = torch.arange(self.nrows, dtype=self.indices.dtype, device=self.indptr.device)
        return torch.repeat_interleave(rows, self.degrees(), output_size=self.nnz)

    def is_sorted(self) -> bool:
        if self.nnz <= 1:
            return True
        row = self.row_of_nnz()
        same_row = row[1:] == row[:-1]
        descending = self.indices[1:] < self.indices[:-1]
        return not bool(torch.any(same_row & descending))

    def sort_rows(self) -> "CSR":
        """Stable-sort column ids (and vals) within each row (kernel K4 with
        no row or column order)."""
        from ..ops.kernels.relocate import relocate_csr

        return relocate_csr(self)

    def astype(self, id_dtype=None, nnz_dtype=None, value_dtype=None) -> "CSR":
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
        dense.index_put_(
            (self.row_of_nnz().long(), self.indices.long()), vals, accumulate=True
        )
        return dense

    def __repr__(self) -> str:
        return (
            f"CSR(shape={self._shape}, nnz={self.nnz}, "
            f"dtypes=({self.id_dtype},{self.nnz_dtype},{self.value_dtype}), "
            f"context={self.context!r})"
        )
