"""Reorderer base: ops producing inverse permutations.

Counterpart of ``sparsebase_tpu/ops/reorder/base.py`` (reference
src/sparsebase/reorder/reorderer.h:37-118). Every reorderer returns an
inverse permutation ``order[old_id] = new_id`` (reorderer.h:49-52) as an
int32 tensor on the input's device.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ...context import Context
from ...dispatch import Operation
from ...formats.base import Format
from ..kernels.radix import radix_rank


class Reorderer(Operation):
    """Base class; subclasses register per-format implementations in their
    constructor and set ``self.params``."""

    params: Any = None

    def get_reorder(
        self, fmt: Format, context: Optional[Context] = None, convert_input: bool = True
    ):
        """The inverse permutation (GetReorder, reorderer.h:57-76)."""
        return self.execute(self.params, fmt, context=context, convert_input=convert_input)

    def get_reorder_cached(
        self, fmt: Format, context: Optional[Context] = None, convert_input: bool = True
    ):
        """Also returns the converted intermediates (GetReorderCached)."""
        return self.execute_cached(
            self.params, fmt, context=context, convert_input=convert_input
        )


def ranks_from_sort_keys(keys: torch.Tensor, key_bits=None) -> torch.Tensor:
    """Inverse permutation placing items in ascending-key order:
    ``rank[v]`` = position of ``v`` after a stable sort of ``keys`` (int32;
    kernel K5 on CUDA tensors). ``key_bits`` states which bits of the keys
    can be set, where the caller knows (``ops/kernels/radix.py``)."""
    return radix_rank(keys, key_bits)
