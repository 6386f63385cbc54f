"""Carry formats across from the JAX reference package, and back to numpy.

The reference formats are read by their field names (``COO.row/col/vals``,
``CSR.indptr/indices/vals``, ``DIA.offsets/data``, each with ``_shape``),
with every array taken through ``np.asarray``, so this module never
imports ``jax`` or ``sparsebase_tpu``. Ids become int32 (checked), CSR
offsets int64; values keep their dtype, bf16 included.
"""

from __future__ import annotations

import numpy as np
import torch

from .formats.base import Format
from .formats.coo import COO
from .formats.csr import CSR
from .formats.dia import DIA
from .utils.exceptions import TypeMismatchError
from .utils.typing import convert_array_dtype


def _tensor(a) -> torch.Tensor:
    """A CPU tensor holding a copy of the array's data."""
    arr = np.ascontiguousarray(np.asarray(a))
    if arr.dtype.name == "bfloat16":  # numpy has no native bf16: move the bits
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _ids(a, device) -> torch.Tensor:
    return convert_array_dtype(_tensor(a), torch.int32).to(device)


def _vals(a, device):
    return None if a is None else _tensor(a).to(device)


def from_reference(fmt, device) -> Format:
    """The port's counterpart of a reference COO, CSR or DIA, on ``device``."""
    if not hasattr(fmt, "_shape"):
        raise TypeMismatchError(f"no port counterpart for {type(fmt).__name__}")
    shape = tuple(int(s) for s in fmt._shape)
    if hasattr(fmt, "row") and hasattr(fmt, "col"):
        return COO(_ids(fmt.row, device), _ids(fmt.col, device), _vals(fmt.vals, device), shape)
    if hasattr(fmt, "indptr") and hasattr(fmt, "indices"):
        indptr = _tensor(fmt.indptr).to(device=device, dtype=torch.int64)
        return CSR(indptr, _ids(fmt.indices, device), _vals(fmt.vals, device), shape)
    if hasattr(fmt, "offsets") and hasattr(fmt, "data"):
        return DIA(_ids(fmt.offsets, device), _vals(fmt.data, device), shape)
    raise TypeMismatchError(f"no port counterpart for {type(fmt).__name__}")


def _numpy(t):
    if t is None:
        return None
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def to_numpy(fmt: Format) -> dict:
    """The format's arrays as numpy (bf16 widened to f32), keyed by field
    name, plus ``shape``."""
    out = {"shape": fmt.shape}
    for name in ("row", "col", "indptr", "indices", "offsets", "data", "vals"):
        if hasattr(fmt, name):
            out[name] = _numpy(getattr(fmt, name))
    return out
