"""Preprocessing operations: reorder, permute, features, and the hand-written
kernels.

Reference analogue: src/sparsebase/{reorder,permute,feature}/.
"""

from . import feature, kernels, permute, reorder

__all__ = ["feature", "kernels", "permute", "reorder"]
