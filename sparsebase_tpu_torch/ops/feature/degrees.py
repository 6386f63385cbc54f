"""Row-degree features: Degrees, DegreeDistribution, and the fused pair.

Counterpart of ``sparsebase_tpu/ops/feature/degrees.py`` (reference:
src/sparsebase/feature/degrees.cc, degree_distribution.cc,
degrees_degree_distribution.cc:109-150). Degrees have the ids' dtype; the
distribution is each degree over ``max(nnz, 1)``, one IEEE division in the
float type (float32 unless asked), as the JAX package computes it.
"""

from __future__ import annotations

import dataclasses

import torch

from ...formats.csr import CSR
from .base import Feature, FusedFeature


def _row_degrees(csr: CSR) -> torch.Tensor:
    return (csr.indptr[1:] - csr.indptr[:-1]).to(csr.indices.dtype)


def _distribution(csr: CSR, deg: torch.Tensor, float_dtype: torch.dtype) -> torch.Tensor:
    # a divisor tensor on the degrees' device: a Python number would let the
    # CUDA kernel multiply by its reciprocal, which is not the same rounding
    nnz = torch.full((), float(max(csr.nnz, 1)), dtype=float_dtype, device=deg.device)
    return deg.to(float_dtype) / nnz


class Degrees(Feature):
    """Per-row degree array (feature/degrees.cc ``GetDegreesCSR``)."""

    def __init__(self):
        super().__init__("degrees")
        self.register((CSR,), lambda f, p: _row_degrees(f[0]))

    def get_degrees(self, fmt, context=None, convert_input=True):
        return self.execute(self.params, fmt, context=context, convert_input=convert_input)


@dataclasses.dataclass
class DegreeDistributionParams:
    float_dtype: torch.dtype = torch.float32


class DegreeDistribution(Feature):
    """degree / nnz per vertex (feature/degree_distribution.cc)."""

    def __init__(self, float_dtype: torch.dtype = torch.float32):
        super().__init__("degree_distribution")
        self.params = DegreeDistributionParams(float_dtype)
        self.register((CSR,), self._impl)

    @staticmethod
    def _impl(formats, params):
        return _distribution(formats[0], _row_degrees(formats[0]), params.float_dtype)

    def get_distribution(self, fmt, context=None, convert_input=True):
        return self.execute(self.params, fmt, context=context, convert_input=convert_input)


class DegreesDegreeDistribution(FusedFeature):
    """{Degrees, DegreeDistribution} in one pass (degrees_degree_distribution.cc:109-150)."""

    SUB_FEATURES = (Degrees, DegreeDistribution)

    def __init__(self):
        super().__init__("degrees_degree_distribution")
        self.params = DegreeDistributionParams()
        self.register((CSR,), self._impl)

    @staticmethod
    def _impl(formats, params):
        deg = _row_degrees(formats[0])
        return {Degrees: deg, DegreeDistribution: _distribution(formats[0], deg, params.float_dtype)}
