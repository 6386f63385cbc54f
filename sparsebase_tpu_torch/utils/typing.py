"""Dtype utilities: overflow-checked tensor casting.

Counterpart of ``sparsebase_tpu/utils/typing.py`` (reference:
``CanTypeFitValue`` / ``ConvertArrayType``, src/sparsebase/utils/utils.h:39-149).
PyTorch runs eagerly, so every cast can be checked: a narrowing conversion
of an index or value tensor raises instead of wrapping.
"""

from __future__ import annotations

import torch

from .exceptions import TypeMismatchError

# The dtype universes of the reference's CMake type lists (CMakeLists.txt:15-18),
# as in ``sparsebase_tpu/utils/typing.py:26-29``; no code reads them.
ID_DTYPES = (torch.int32, torch.uint32, torch.int64, torch.uint64)
NNZ_DTYPES = (torch.int32, torch.uint32, torch.int64, torch.uint64)
VALUE_DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.int32, torch.int64)
FLOAT_DTYPES = (torch.float32, torch.float64, torch.bfloat16)


def can_dtype_fit(to_dtype: torch.dtype, values: torch.Tensor) -> bool:
    """True iff every element of ``values`` is exactly representable in
    ``to_dtype`` (float narrowing checks the magnitude range only, as the
    reference package does: precision loss is allowed for value arrays)."""
    if values.numel() == 0:
        return True
    if values.dtype == torch.bool:
        return True
    if not to_dtype.is_floating_point:
        info = torch.iinfo(to_dtype)
        if values.dtype.is_floating_point:
            if not bool(torch.all(values == torch.trunc(values))):
                return False
            lo, hi = values.double().min(), values.double().max()
        else:
            lo, hi = int(values.min()), int(values.max())
        return bool(lo >= info.min) and bool(hi <= info.max)
    if not values.dtype.is_floating_point:
        return bool(torch.all(values.to(to_dtype).to(values.dtype) == values))
    finite = values[torch.isfinite(values)]
    if finite.numel() == 0:
        return True
    return bool(finite.double().abs().max() <= torch.finfo(to_dtype).max)


def convert_array_dtype(values, to_dtype: torch.dtype, *, check: bool = True):
    """Cast a tensor to ``to_dtype``; raises ``TypeMismatchError`` when an
    element does not fit (``ConvertArrayType``, utils/utils.h:113-149)."""
    if values is None:
        return None
    if values.dtype == to_dtype:
        return values
    if check and not can_dtype_fit(to_dtype, values):
        raise TypeMismatchError(
            f"Tensor with dtype {values.dtype} contains values that do not fit in {to_dtype}"
        )
    return values.to(to_dtype)


def index_dtype_for(n: int) -> torch.dtype:
    """The narrowest index type that addresses ``n`` items: int32 up to
    2^31 - 1, int64 beyond (``sparsebase_tpu/utils/typing.py:88``)."""
    return torch.int32 if n <= torch.iinfo(torch.int32).max else torch.int64
