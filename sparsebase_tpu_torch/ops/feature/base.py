"""Feature-extraction framework: features as operations, and fused extraction.

Counterpart of ``sparsebase_tpu/ops/feature/base.py`` (reference:
src/sparsebase/feature/feature_preprocess_type.h:9-18,
feature/extractor.{h,cc}, utils/extractable.h). A :class:`Feature` is an
auto-converting :class:`Operation` whose ``extract`` returns
``{feature_class: value}``; a :class:`FusedFeature` returns several entries
from one pass. :class:`Extractor` covers a requested set of features with the
largest registered classes (``ClassMatcher``) and merges their results
(extractor.cc:44-56). A feature runs on the device of its input's tensors.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Type

from ...context import Context
from ...dispatch import ClassMatcher, Operation
from ...formats.base import Format
from ...utils.exceptions import FeatureError


class Feature(Operation):
    """``Extractable``: a dispatchable feature with its params."""

    def __init__(self, name: str):
        super().__init__(name)
        self.params: Any = None
        self.pmap: Dict[type, Any] = {}  # per-sub-feature params (Extractable::pmap_)

    @classmethod
    def feature_id(cls) -> type:
        """The class plays the role of ``std::type_index``."""
        return cls

    def get_sub_ids(self) -> List[type]:
        return [type(self)]

    def get_subs(self) -> List["Feature"]:
        return [self]

    def extract(self, fmt: Format, context: Optional[Context] = None, convert_input: bool = True) -> Dict[type, Any]:
        return {type(self): self.execute(self.params, fmt, context=context, convert_input=convert_input)}


class FusedFeature(Feature):
    """Several sub-features in one pass: subclasses set ``SUB_FEATURES`` and
    register an implementation that returns a dict keyed by those classes
    (degrees_degree_distribution.cc:78-150)."""

    SUB_FEATURES: Sequence[Type[Feature]] = ()

    def get_sub_ids(self) -> List[type]:
        return sorted(self.SUB_FEATURES, key=lambda c: c.__name__)

    def get_subs(self) -> List[Feature]:
        return [cls() for cls in self.get_sub_ids()]

    def extract(self, fmt: Format, context: Optional[Context] = None, convert_input: bool = True) -> Dict[type, Any]:
        out = self.execute(self.params, fmt, context=context, convert_input=convert_input)
        if not isinstance(out, dict):
            raise FeatureError(f"{self.name}: a fused implementation must return a dict")
        return out


class Extractor:
    """``feature::Extractor``: runs the requested features, each through the
    largest registered (possibly fused) class that covers it, and unions the
    results."""

    def __init__(self):
        self._matcher = ClassMatcher()
        self._in: Dict[type, Feature] = {}

    def register_class(self, feature_cls: Type[Feature]) -> None:
        """``ClassMatcherMixin::RegisterClass``."""
        self._matcher.register(feature_cls().get_sub_ids(), feature_cls)

    def add(self, feature: Feature) -> None:
        for fid in feature.get_sub_ids():
            self._in[fid] = feature

    def subtract(self, feature: Feature) -> None:
        for fid in feature.get_sub_ids():
            self._in.pop(fid, None)

    def get_list(self) -> List[type]:
        return sorted(self._in, key=lambda c: c.__name__)

    def extract(
        self,
        fmt: Format,
        features: Optional[Sequence] = None,
        context: Optional[Context] = None,
        convert_input: bool = True,
    ) -> Dict[type, Any]:
        """The requested features (classes or instances), or the added ones."""
        ids = self.get_list() if features is None else [f if isinstance(f, type) else type(f) for f in features]
        result: Dict[type, Any] = {}
        for inst in self._matcher.match(ids):
            result.update(inst.extract(fmt, context=context, convert_input=convert_input))
        return result if features is None else {k: v for k, v in result.items() if k in ids}
