"""Format conversion: graph, BFS path-finding, and conversion functions.

Reference analogue: src/sparsebase/converter/ (SURVEY.md §2.3).
"""

from .graph import (
    ConversionGraph,
    can_convert,
    convert,
    convert_cached,
    default_graph,
    register_conversion,
)
from .kernels import coo_to_csr, csr_to_coo, csr_to_dia, dia_to_csr

__all__ = [
    "ConversionGraph",
    "can_convert",
    "convert",
    "convert_cached",
    "default_graph",
    "register_conversion",
    "coo_to_csr",
    "csr_to_coo",
    "csr_to_dia",
    "dia_to_csr",
]
