"""Feature extraction (reference: src/sparsebase/feature/).

Counterpart of ``sparsebase_tpu/ops/feature``: the reference's 19 features
and the fused-extraction framework, plus :class:`FillIn` (nnz(L) of the
symbolic factorisation). ``FeatureExtractor()`` comes registered with every
feature class (feature/feature_extractor.cc:12-28, extended to the full set).
Features run on the device of their input's tensors; on a CUDA CSR,
``JaccardWeights`` and ``TriangleCount`` launch kernel K6 (a directed count
up to 16,384 vertices takes a dense product instead).
"""

from .base import Extractor, Feature, FusedFeature
from .column_stats import (
    AvgDegreeColumn,
    CoefficientOfVariationDegreeColumn,
    GeometricAvgDegreeColumn,
    MaxDegreeColumn,
    MedianDegreeColumn,
    MinDegreeColumn,
    StandardDeviationDegreeColumn,
)
from .degree_stats import AvgDegree, MaxDegree, MinDegree, MinMaxAvgDegree
from .degrees import DegreeDistribution, Degrees, DegreesDegreeDistribution
from .fill import FillIn
from .jaccard import JaccardWeights
from .structure import Bandwidth, OffDiagBlockNNZ, Profile
from .triangles import TriangleCount

ALL_FEATURES = (
    Degrees,
    DegreeDistribution,
    DegreesDegreeDistribution,
    MinDegree,
    MaxDegree,
    AvgDegree,
    MinMaxAvgDegree,
    MinDegreeColumn,
    MaxDegreeColumn,
    AvgDegreeColumn,
    MedianDegreeColumn,
    StandardDeviationDegreeColumn,
    CoefficientOfVariationDegreeColumn,
    GeometricAvgDegreeColumn,
    Bandwidth,
    Profile,
    OffDiagBlockNNZ,
    TriangleCount,
    JaccardWeights,
    FillIn,
)

# the reference's own set: every feature but FillIn
REFERENCE_FEATURES = ALL_FEATURES[:-1]


class FeatureExtractor(Extractor):
    """An Extractor registered with every feature class, fused ones included."""

    def __init__(self):
        super().__init__()
        for cls in ALL_FEATURES:
            self.register_class(cls)


__all__ = [
    "Feature",
    "FusedFeature",
    "Extractor",
    "FeatureExtractor",
    "ALL_FEATURES",
    "REFERENCE_FEATURES",
    "Degrees",
    "DegreeDistribution",
    "DegreesDegreeDistribution",
    "MinDegree",
    "MaxDegree",
    "AvgDegree",
    "MinMaxAvgDegree",
    "MinDegreeColumn",
    "MaxDegreeColumn",
    "AvgDegreeColumn",
    "MedianDegreeColumn",
    "StandardDeviationDegreeColumn",
    "CoefficientOfVariationDegreeColumn",
    "GeometricAvgDegreeColumn",
    "Bandwidth",
    "Profile",
    "OffDiagBlockNNZ",
    "TriangleCount",
    "JaccardWeights",
    "FillIn",
]
