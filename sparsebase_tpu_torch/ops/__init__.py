"""Preprocessing operations: reorder, permute, and the hand-written kernels.

Reference analogue: src/sparsebase/{reorder,permute}/.
"""

from . import kernels, permute, reorder

__all__ = ["kernels", "permute", "reorder"]
