"""Dense order-1 array format.

Counterpart of ``sparsebase_tpu/formats/array.py`` (reference
src/sparsebase/format/array.h:16-36): permutation vectors, feature outputs
and dense operands. A ``DenseArray`` on a CUDA tensor plays the role of the
reference's ``CUDAArray``: placement is the tensor's device, not a class.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..utils.typing import convert_array_dtype
from .base import Format, register_format


@register_format
@dataclasses.dataclass(frozen=True)
class DenseArray(Format):
    """Order-1 dense array."""

    vals: torch.Tensor  # (n,)

    order = 1

    @staticmethod
    def new(vals) -> "DenseArray":
        return DenseArray(vals)

    @property
    def shape(self) -> Tuple[int]:
        return (int(self.vals.shape[0]),)

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    @property
    def value_dtype(self):
        return self.vals.dtype

    def astype(self, value_dtype=None, **_) -> "DenseArray":
        if value_dtype is None:
            return self
        return dataclasses.replace(self, vals=convert_array_dtype(self.vals, value_dtype))

    def __repr__(self) -> str:
        return f"DenseArray(n={self.nnz}, dtype={self.vals.dtype}, context={self.context!r})"


# Alias matching the reference class name.
Array = DenseArray
