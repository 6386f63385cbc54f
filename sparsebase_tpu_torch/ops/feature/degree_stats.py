"""Scalar row-degree statistics: min, max, average and the fused triple.

Counterpart of ``sparsebase_tpu/ops/feature/degree_stats.py`` (reference:
src/sparsebase/feature/min_degree.cc, max_degree.cc, avg_degree.cc,
min_max_avg_degree.cc). Min and max are 0-d tensors on the input's device;
the average is a Python float.
"""

from __future__ import annotations

from ...formats.csr import CSR
from .base import Feature, FusedFeature
from .degrees import _row_degrees


def _avg(csr: CSR) -> float:
    return csr.nnz / max(csr.nrows, 1)


class MinDegree(Feature):
    def __init__(self):
        super().__init__("min_degree")
        self.register((CSR,), lambda f, p: _row_degrees(f[0]).min())


class MaxDegree(Feature):
    def __init__(self):
        super().__init__("max_degree")
        self.register((CSR,), lambda f, p: _row_degrees(f[0]).max())


class AvgDegree(Feature):
    """nnz / nrows as a float (avg_degree.cc)."""

    def __init__(self):
        super().__init__("avg_degree")
        self.register((CSR,), lambda f, p: _avg(f[0]))


class MinMaxAvgDegree(FusedFeature):
    """All three in one pass (min_max_avg_degree.cc)."""

    SUB_FEATURES = (MinDegree, MaxDegree, AvgDegree)

    def __init__(self):
        super().__init__("min_max_avg_degree")
        self.register((CSR,), self._impl)

    @staticmethod
    def _impl(formats, params):
        deg = _row_degrees(formats[0])
        return {MinDegree: deg.min(), MaxDegree: deg.max(), AvgDegree: _avg(formats[0])}
