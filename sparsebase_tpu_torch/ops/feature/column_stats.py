"""Column-degree statistics, computed on CSC like the reference.

Counterpart of ``sparsebase_tpu/ops/feature/column_stats.py`` (reference:
src/sparsebase/feature/{min,max,avg}_degree_column.cc,
median_degree_column.cc, standard_deviation_degree_column.cc,
coefficient_of_variation_degree_column.cc, geometric_avg_degree_column.cc).
Every one registers on CSC, so a CSR converts through ``csr_to_csc``.
Statistics are float64 on any device, as the JAX package's host route
computes them, and 0-d tensors on the input's device.

The reference's formulas, quirks kept:

* the standard deviation is ``sqrt(sum((d - mean)^2))``, not divided by the
  count (standard_deviation_degree_column.cc:137-141);
* the coefficient of variation is that over the mean, ``inf`` for a mean of 0;
* the geometric mean is ``exp(mean(log d))``: an empty column makes the log
  sum ``-inf`` and the result 0;
* the median averages the two middle degrees of an even count, as
  ``np.median`` does (``torch.median`` returns the lower one).
"""

from __future__ import annotations

import torch

from ...formats.csc import CSC
from .base import Feature


def _col_degrees(csc: CSC) -> torch.Tensor:
    return csc.indptr[1:] - csc.indptr[:-1]


def _avg(csc: CSC) -> float:
    return csc.nnz / max(csc.ncols, 1)


class MinDegreeColumn(Feature):
    def __init__(self):
        super().__init__("min_degree_column")
        self.register((CSC,), lambda f, p: _col_degrees(f[0]).min())


class MaxDegreeColumn(Feature):
    def __init__(self):
        super().__init__("max_degree_column")
        self.register((CSC,), lambda f, p: _col_degrees(f[0]).max())


class AvgDegreeColumn(Feature):
    def __init__(self):
        super().__init__("avg_degree_column")
        self.register((CSC,), lambda f, p: _avg(f[0]))


class MedianDegreeColumn(Feature):
    def __init__(self):
        super().__init__("median_degree_column")
        self.register((CSC,), self._impl)

    @staticmethod
    def _impl(formats, params):
        deg = torch.sort(_col_degrees(formats[0])).values.to(torch.float64)
        n = deg.numel()
        if n == 0:
            return torch.full((), float("nan"), dtype=torch.float64, device=deg.device)
        if n % 2:
            return deg[n // 2]
        return (deg[n // 2 - 1] + deg[n // 2]) / 2


class StandardDeviationDegreeColumn(Feature):
    def __init__(self):
        super().__init__("standard_deviation_degree_column")
        self.register((CSC,), self._impl)

    @staticmethod
    def _impl(formats, params):
        csc: CSC = formats[0]
        f = _col_degrees(csc).to(torch.float64)
        return torch.sqrt(((f - _avg(csc)) ** 2).sum())


class CoefficientOfVariationDegreeColumn(Feature):
    def __init__(self):
        super().__init__("coefficient_of_variation_degree_column")
        self.register((CSC,), self._impl)

    @staticmethod
    def _impl(formats, params):
        avg = _avg(formats[0])
        return StandardDeviationDegreeColumn._impl(formats, params) / avg if avg else float("inf")


class GeometricAvgDegreeColumn(Feature):
    def __init__(self):
        super().__init__("geometric_avg_degree_column")
        self.register((CSC,), self._impl)

    @staticmethod
    def _impl(formats, params):
        csc: CSC = formats[0]
        logs = torch.log(_col_degrees(csc).to(torch.float64))
        return torch.exp(logs.sum() / max(csc.ncols, 1))
