"""Degree reordering: stable sort of the rows by degree.

Counterpart of ``sparsebase_tpu/ops/reorder/degree.py`` (reference
``reorder::DegreeReorder``, src/sparsebase/reorder/degree_reorder.cc:20-60).
The reference runs a counting sort; one stable key sort gives the same
tie order. On the card that sort is kernel K5, which is told that a degree
is at most ``nnz`` and so plans only the bytes that ``nnz`` has. The
descending order sorts ``mask - degrees`` with ``mask = 2**k - 1 >= nnz``:
the same order and ties as ``-degrees``, and every bit above the largest
degree is set in all keys, so those bytes hold one value and the kernel
skips them (``nnz - degrees`` would borrow into a second byte wherever a
row is empty).
"""

from __future__ import annotations

import dataclasses

from ...formats.csr import CSR
from .base import Reorderer, ranks_from_sort_keys


@dataclasses.dataclass
class DegreeReorderParams:
    ascending: bool = True


def _degree_reorder_csr(formats, params: DegreeReorderParams):
    csr: CSR = formats[0]
    degrees = csr.degrees()
    bits = csr.nnz.bit_length()  # degrees lie in [0, nnz]
    return ranks_from_sort_keys(degrees if params.ascending else (1 << bits) - 1 - degrees, key_bits=bits)


class DegreeReorder(Reorderer):
    def __init__(self, ascending: bool = True):
        super().__init__("degree_reorder")
        self.params = DegreeReorderParams(ascending)
        self.register((CSR,), _degree_reorder_csr)
