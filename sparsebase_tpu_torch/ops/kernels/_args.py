"""What the card wrappers do to index tensors before a launch.

The kernels read int64 offsets and int32 ids. The formats accept any integer
type, so a wrapper converts first: offsets are widened, ids are narrowed by
the checked cast of ``utils/typing.py`` (it raises where an id does not fit,
and reads the ids' range back to the host to know). Tensors already in the
kernel's type pass through untouched, with no copy and no host read.
"""

from __future__ import annotations

import torch

from ...utils.exceptions import TypeMismatchError
from ...utils.typing import convert_array_dtype


def _require_integer(t: torch.Tensor, what: str) -> None:
    if t.dtype.is_floating_point or t.dtype.is_complex or t.dtype == torch.bool:
        raise TypeMismatchError(f"{what}: needs an integer tensor, got {t.dtype}")


def kernel_offsets(indptr: torch.Tensor, what: str) -> torch.Tensor:
    """``indptr`` as contiguous int64."""
    _require_integer(indptr, what)
    return indptr.to(torch.int64).contiguous()


def kernel_ids(ids: torch.Tensor, what: str) -> torch.Tensor:
    """``ids`` as contiguous int32; raises ``TypeMismatchError`` on an id
    that int32 does not hold."""
    _require_integer(ids, what)
    return convert_array_dtype(ids, torch.int32).contiguous()
