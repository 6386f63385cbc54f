"""DIA (diagonal) format — the banded-matrix container.

Counterpart of ``sparsebase_tpu/formats/dia.py``. Layout:
``data[d, i] = A[i, i + offsets[d]]`` (zero where out of range), offsets
int32 and sorted ascending. SpMV over it reads the band as dense rows with
no index arrays (ops/kernels/banded_spmv.py).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..utils.typing import convert_array_dtype
from .base import Format, register_format


@register_format
@dataclasses.dataclass(frozen=True)
class DIA(Format):
    """Order-2 banded matrix as dense diagonals."""

    offsets: torch.Tensor  # (k,) int32, sorted; offset = col - row
    data: torch.Tensor  # (k, nrows) values
    _shape: Tuple[int, int] = (0, 0)

    order = 2

    @staticmethod
    def new(offsets, data, shape) -> "DIA":
        return DIA(offsets, data, (int(shape[0]), int(shape[1])))

    @property
    def shape(self) -> Tuple[int, int]:
        return self._shape

    @property
    def nnz(self) -> int:
        """Count of stored nonzeros (explicit zeros in the band excluded)."""
        return int((self.data != 0).sum())

    @property
    def num_diagonals(self) -> int:
        return int(self.offsets.shape[0])

    @property
    def bandwidth(self) -> int:
        return int(self.offsets.abs().max()) if self.offsets.numel() else 0

    @property
    def value_dtype(self):
        return self.data.dtype

    def astype(self, value_dtype=None, **_) -> "DIA":
        if value_dtype is None:
            return self
        return dataclasses.replace(self, data=convert_array_dtype(self.data, value_dtype))

    def to_dense(self) -> torch.Tensor:
        n, m = self._shape
        dense = torch.zeros((n, m), dtype=self.data.dtype, device=self.data.device)
        i = torch.arange(n, device=self.data.device)
        for d, off in enumerate(self.offsets.tolist()):
            j = i + off
            ok = (j >= 0) & (j < m)
            dense[i[ok], j[ok]] = self.data[d, i[ok]]
        return dense

    def __repr__(self) -> str:
        return (
            f"DIA(shape={self._shape}, diagonals={self.num_diagonals}, "
            f"bandwidth={self.bandwidth}, context={self.context!r})"
        )
