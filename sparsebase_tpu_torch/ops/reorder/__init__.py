"""Reordering algorithms (reference: src/sparsebase/reorder/).

All reorderers return inverse permutations ``order[old_id] = new_id``.
"""

from .base import Reorderer, ranks_from_sort_keys
from .degree import DegreeReorder, DegreeReorderParams
from .rcm import RCMReorder, RCMReorderParams

__all__ = [
    "Reorderer",
    "ranks_from_sort_keys",
    "DegreeReorder",
    "DegreeReorderParams",
    "RCMReorder",
    "RCMReorderParams",
]
