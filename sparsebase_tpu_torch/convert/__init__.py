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
from .kernels import (
    coo_to_csc,
    coo_to_csr,
    csc_to_coo,
    csc_to_csr,
    csr_to_coo,
    csr_to_csc,
    csr_to_dia,
    csr_to_ell,
    dia_to_csr,
    ell_to_csr,
)

__all__ = [
    "ConversionGraph",
    "can_convert",
    "convert",
    "convert_cached",
    "default_graph",
    "register_conversion",
    "coo_to_csr",
    "csr_to_coo",
    "coo_to_csc",
    "csc_to_coo",
    "csr_to_csc",
    "csc_to_csr",
    "csr_to_dia",
    "dia_to_csr",
    "csr_to_ell",
    "ell_to_csr",
]
