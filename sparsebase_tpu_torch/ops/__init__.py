"""Preprocessing operations: reorder, permute, partition, feature, and the
hand-written kernels.

Reference analogue: src/sparsebase/{reorder,permute,partition,feature}/.
"""

from . import feature, kernels, partition, permute, reorder

__all__ = ["feature", "kernels", "partition", "permute", "reorder"]
