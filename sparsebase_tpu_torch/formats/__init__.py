"""Sparse containers holding torch tensors (reference: src/sparsebase/format/)."""

from .array import Array, DenseArray
from .base import Format, register_format, registered_formats
from .coo import COO
from .csc import CSC
from .csr import CSR
from .dia import DIA
from .ell import ELL
from .padded import PaddedCSR, next_bucket, pad_csr

__all__ = [
    "Format",
    "COO",
    "CSR",
    "CSC",
    "DIA",
    "ELL",
    "DenseArray",
    "Array",
    "PaddedCSR",
    "next_bucket",
    "pad_csr",
    "register_format",
    "registered_formats",
]
