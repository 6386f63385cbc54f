"""Operation dispatch with automatic input conversion.

Counterpart of ``sparsebase_tpu/dispatch.py`` (reference
``FunctionMatcherMixin``, src/sparsebase/utils/function_matcher_mixin.h:40-418):
an operation maps tuples of input format classes to implementations.
Execution looks for an exact key first; failing that it asks the
conversion graph for the cheapest chain to some registered key, applies
it, and runs the matched function. Every dispatched op and every
auto-conversion is a named span while a profiler runs (``utils/tracing.py``).

Also here: :class:`ClassMatcher`, the analogue of ``ClassMatcherMixin``
(utils/class_matcher_mixin.h:12-170).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Type

from .context import Context
from .convert.graph import ConversionGraph, apply_edge, default_graph, move
from .formats.base import Format
from .utils.exceptions import DirectExecutionNotAvailableError, FunctionNotFoundError
from .utils.tracing import span

Key = Tuple[Type[Format], ...]
ImplFn = Callable[..., Any]


class Operation:
    """Multi-format operation with auto-conversion dispatch::

        op = Operation("reorder")
        op.register((CSR,), my_csr_impl)
        result = op.execute(params, some_coo)   # converts COO→CSR first
    """

    def __init__(self, name: str = "op", graph: Optional[ConversionGraph] = None):
        self.name = name
        self._graph = graph
        self._registry: Dict[Key, ImplFn] = {}

    def register(self, key: Sequence[Type[Format]], fn: ImplFn, overwrite: bool = True) -> bool:
        key = tuple(key)
        if not overwrite and key in self._registry:
            return False
        self._registry[key] = fn
        return True

    def unregister(self, key: Sequence[Type[Format]]) -> bool:
        return self._registry.pop(tuple(key), None) is not None

    def registered_keys(self) -> List[Key]:
        return list(self._registry)

    def graph(self) -> ConversionGraph:
        return self._graph or default_graph()

    def _match(
        self, formats: Sequence[Format], context: Optional[Context]
    ) -> Tuple[ImplFn, List[Optional[List]]]:
        """(fn, per-input conversion chains): exact match first, else the
        key reachable with the fewest conversions (GetFunction :335-416)."""
        in_key = tuple(type(f) for f in formats)
        if in_key in self._registry:
            return self._registry[in_key], [None] * len(formats)
        graph = self.graph()
        best = None
        for key, fn in self._registry.items():
            if len(key) != len(formats):
                continue
            chains = []
            total = 0
            for fmt, target in zip(formats, key):
                if isinstance(fmt, target):
                    chains.append(None)
                    continue
                chain = graph.get_chain(type(fmt), target, fmt.context, context)
                if chain is None:
                    break
                chains.append(chain)
                total += len(chain)
            else:
                if best is None or total < best[0]:
                    best = (total, fn, chains)
        if best is None:
            raise FunctionNotFoundError(
                f"{self.name}: no implementation reachable for input types "
                f"({', '.join(t.__name__ for t in in_key)})"
            )
        return best[1], best[2]

    def execute(
        self,
        params: Any,
        *formats: Format,
        context: Optional[Context] = None,
        convert_input: bool = True,
    ) -> Any:
        """Dispatch and run, converting inputs if needed (Execute :228-245).
        With ``convert_input=False`` only an exact key may match."""
        _, result = self.execute_cached(
            params, *formats, context=context, convert_input=convert_input
        )
        return result

    def execute_cached(
        self,
        params: Any,
        *formats: Format,
        context: Optional[Context] = None,
        convert_input: bool = True,
    ) -> Tuple[List[Optional[Format]], Any]:
        """Like ``CachedExecute`` (:171-226): also returns, per input, the
        converted format actually consumed (None if used as-is)."""
        in_key = tuple(type(f) for f in formats)
        if not convert_input and in_key not in self._registry:
            raise DirectExecutionNotAvailableError(in_key, self._registry.keys())
        fn, chains = self._match(formats, context)
        converted: List[Optional[Format]] = []
        final_inputs: List[Format] = []
        for fmt, chain in zip(formats, chains):
            cur = fmt
            if context is not None and not cur.context.is_equivalent(context):
                cur = move(cur, context)
            for f, cls in chain or ():
                cur = apply_edge(f, cur, cls)
            converted.append(None if cur is fmt else cur)
            final_inputs.append(cur)
        with span(f"sbtorch:op:{self.name}"):
            return converted, fn(final_inputs, params)


class ClassMatcher:
    """Greedy largest-subset cover for fused feature extraction
    (``ClassMatcherMixin``, utils/class_matcher_mixin.h:12-170)."""

    def __init__(self):
        self._classes: Dict[frozenset, Callable[[], Any]] = {}

    def register(self, ids: Sequence, factory: Callable[[], Any]) -> None:
        self._classes[frozenset(ids)] = factory

    def match(self, ids: Sequence) -> List[Any]:
        need = set(ids)
        chosen: List[Any] = []
        while need:
            best = None
            for key in sorted(self._classes, key=len, reverse=True):
                if key <= need:
                    best = key
                    break
            if best is None:
                raise FunctionNotFoundError(
                    f"No registered class produces features {sorted(map(str, need))}"
                )
            chosen.append(self._classes[best]())
            need -= best
        return chosen
