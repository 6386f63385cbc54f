"""Generic (user-extensible) reorderer.

Counterpart of ``sparsebase_tpu/ops/reorder/generic.py`` (reference
``reorder::GenericReorder``, src/sparsebase/reorder/generic_reorder.cc): an
empty shell into which users register their own implementations::

    op = GenericReorder()
    op.register((CSR,), my_impl)
    order = op.get_reorder(fmt)
"""

from __future__ import annotations

from .base import Reorderer


class GenericReorder(Reorderer):
    def __init__(self):
        super().__init__("generic_reorder")
        self.params = None
