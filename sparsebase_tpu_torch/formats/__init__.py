"""Sparse containers holding torch tensors (reference: src/sparsebase/format/)."""

from .base import Format, register_format, registered_formats
from .coo import COO
from .csr import CSR
from .dia import DIA

__all__ = ["Format", "COO", "CSR", "DIA", "register_format", "registered_formats"]
