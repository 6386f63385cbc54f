"""Reordering algorithms (reference: src/sparsebase/reorder/).

All reorderers return inverse permutations ``order[old_id] = new_id``, as
int32 tensors on the input's device.
"""

from .amd import AMDReorder, AMDReorderParams
from .base import Reorderer, ranks_from_sort_keys
from .boba import BOBAReorder, BOBAReorderParams
from .degree import DegreeReorder, DegreeReorderParams
from .generic import GenericReorder
from .gray import GrayReorder, GrayReorderParams
from .heatmap import ReorderHeatmap, ReorderHeatmapParams
from .nested_dissection import MetisReorder, MetisReorderParams
from .rabbit import RabbitReorder, RabbitReorderParams
from .rcm import RCMReorder, RCMReorderParams
from .slashburn import SlashburnReorder, SlashburnReorderParams

__all__ = [
    "Reorderer",
    "ranks_from_sort_keys",
    "AMDReorder",
    "AMDReorderParams",
    "MetisReorder",
    "MetisReorderParams",
    "RabbitReorder",
    "RabbitReorderParams",
    "DegreeReorder",
    "DegreeReorderParams",
    "RCMReorder",
    "RCMReorderParams",
    "GrayReorder",
    "GrayReorderParams",
    "BOBAReorder",
    "BOBAReorderParams",
    "SlashburnReorder",
    "SlashburnReorderParams",
    "GenericReorder",
    "ReorderHeatmap",
    "ReorderHeatmapParams",
]
