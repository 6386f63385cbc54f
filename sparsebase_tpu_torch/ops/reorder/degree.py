"""Degree reordering: stable sort of the rows by degree.

Counterpart of ``sparsebase_tpu/ops/reorder/degree.py`` (reference
``reorder::DegreeReorder``, src/sparsebase/reorder/degree_reorder.cc:20-60).
The reference runs a counting sort; one stable key sort gives the same
tie order. On the card that sort is kernel K5, which shifts its keys by
their minimum: the descending order's keys ``-degrees`` become
``max_degree - degrees``, with the same stable tie order.
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
    return ranks_from_sort_keys(degrees if params.ascending else -degrees)


class DegreeReorder(Reorderer):
    def __init__(self, ascending: bool = True):
        super().__init__("degree_reorder")
        self.params = DegreeReorderParams(ascending)
        self.register((CSR,), _degree_reorder_csr)
