"""Coordinate (triplet) format.

Counterpart of ``sparsebase_tpu/formats/coo.py`` (reference
src/sparsebase/format/coo.h:26-, coo.cc). Invariant: entries sorted
row-major by (row, col); :func:`COO.new` checks and repairs it, as the
reference constructor does (coo.cc:112-140). Duplicate coordinates are
kept and accumulate.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..utils.logger import Logger
from ..utils.typing import convert_array_dtype
from .base import Format, register_format

_log = Logger("COO")


@register_format
@dataclasses.dataclass(frozen=True)
class COO(Format):
    """Order-2 sparse matrix as (row, col, val) triplets, row-major sorted."""

    row: torch.Tensor  # (nnz,) int32
    col: torch.Tensor  # (nnz,) int32
    vals: Optional[torch.Tensor]  # (nnz,) or None
    _shape: Tuple[int, int] = (0, 0)

    order = 2

    @staticmethod
    def new(row, col, vals=None, shape=None, *, sort: bool = True, stable_payload: bool = True) -> "COO":
        """Build a COO, checking and repairing the row-major sort
        (coo.cc:112-140). ``stable_payload=False`` allows any order of the
        payloads of duplicate coordinates, as in the JAX package; the sort
        here is stable either way."""
        if shape is None:
            shape = (
                int(row.max()) + 1 if row.numel() else 0,
                int(col.max()) + 1 if col.numel() else 0,
            )
        coo = COO(row, col, vals, (int(shape[0]), int(shape[1])))
        if sort and not coo.is_sorted():
            _log.warning("COO arrays not sorted row-major; sorting.")
            coo = coo.sort_rowmajor(stable_payload=stable_payload)
        return coo

    @property
    def shape(self) -> Tuple[int, int]:
        return self._shape

    @property
    def nnz(self) -> int:
        return int(self.row.shape[0])

    @property
    def nrows(self) -> int:
        return self._shape[0]

    @property
    def ncols(self) -> int:
        return self._shape[1]

    @property
    def id_dtype(self):
        return self.row.dtype

    @property
    def value_dtype(self):
        return None if self.vals is None else self.vals.dtype

    def is_sorted(self) -> bool:
        if self.nnz <= 1:
            return True
        r0, r1 = self.row[:-1], self.row[1:]
        c0, c1 = self.col[:-1], self.col[1:]
        return bool(torch.all((r1 > r0) | ((r1 == r0) & (c1 >= c0))))

    def sort_rowmajor(self, stable_payload: bool = True) -> "COO":
        """Stable sort by (row, col): duplicates keep their input order.
        ``stable_payload=False`` permits any payload order among duplicates
        (``sparsebase_tpu/convert/kernels.py:207-224``); K5 and the CPU's
        ``torch.sort(stable=True)`` keep it stable all the same."""
        from ..convert.kernels import sort_by_pairs

        row, col, vals = sort_by_pairs(self.row, self.col, self.vals, major_bound=self.nrows,
                                       minor_bound=self.ncols)
        return dataclasses.replace(self, row=row, col=col, vals=vals)

    def astype(self, id_dtype=None, nnz_dtype=None, value_dtype=None) -> "COO":
        # nnz_dtype unused: COO carries no offset array (reference
        # TypeConverter for COO, format/coo.h)
        return dataclasses.replace(
            self,
            row=convert_array_dtype(self.row, id_dtype) if id_dtype else self.row,
            col=convert_array_dtype(self.col, id_dtype) if id_dtype else self.col,
            vals=(
                convert_array_dtype(self.vals, value_dtype)
                if (value_dtype and self.vals is not None)
                else self.vals
            ),
        )

    def to_dense(self) -> torch.Tensor:
        vals = self.vals
        if vals is None:
            vals = torch.ones((self.nnz,), dtype=torch.int8, device=self.row.device)
        dense = torch.zeros(self._shape, dtype=vals.dtype, device=vals.device)
        dense.index_put_((self.row.long(), self.col.long()), vals, accumulate=True)
        return dense

    def __repr__(self) -> str:
        return f"COO(shape={self._shape}, nnz={self.nnz}, context={self.context!r})"
