"""Conversion graph: registry + BFS path-finding + chain application.

Counterpart of ``sparsebase_tpu/convert/graph.py`` (reference
src/sparsebase/converter/converter.h:65-350 — ``ConversionMap``
registration :124-128, ``ConversionBFS`` :138-195,
``GetConversionChain`` :197-213, ``ApplyConversionChain`` :253-). Edges
are keyed on format classes with an optional ``condition(from_ctx,
to_ctx)``; a placement move (``Format.to``) runs before the chain, so each
conversion runs where its result must live. PyTorch runs eagerly, so a
chain step is a direct call.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, Optional, Tuple, Type

from ..context import Context
from ..formats.base import Format
from ..utils.exceptions import ConversionError

ConversionFn = Callable[[Format], Format]
Condition = Callable[[Optional[Context], Optional[Context]], bool]


class ConversionGraph:
    """Directed multigraph over format classes with conditional edges."""

    def __init__(self):
        # from_cls -> to_cls -> [(condition | None, fn)]
        self._edges: Dict[Type[Format], Dict[Type[Format], List[Tuple[Optional[Condition], ConversionFn]]]] = {}

    def register(
        self,
        from_cls: Type[Format],
        to_cls: Type[Format],
        fn: ConversionFn,
        condition: Optional[Condition] = None,
    ) -> None:
        self._edges.setdefault(from_cls, {}).setdefault(to_cls, []).append((condition, fn))

    def clear_edge(self, from_cls: Type[Format], to_cls: Type[Format]) -> None:
        self._edges.get(from_cls, {}).pop(to_cls, None)

    def _usable(self, edges, from_ctx, to_ctx) -> Optional[ConversionFn]:
        for condition, fn in edges:
            if condition is None or condition(from_ctx, to_ctx):
                return fn
        return None

    def get_chain(
        self,
        from_cls: Type[Format],
        to_cls: Type[Format],
        from_ctx: Optional[Context] = None,
        to_ctx: Optional[Context] = None,
    ) -> Optional[List[Tuple[ConversionFn, Type[Format]]]]:
        """BFS for the shortest chain of (fn, resulting class) steps; ``[]``
        when no format change is needed, None when unreachable."""
        if from_cls is to_cls or issubclass(from_cls, to_cls):
            return []
        frontier = deque([from_cls])
        parents: Dict[Type[Format], Optional[Tuple[Type[Format], ConversionFn]]] = {from_cls: None}
        while frontier:
            cur = frontier.popleft()
            for nxt, edges in self._edges.get(cur, {}).items():
                if nxt in parents:
                    continue
                fn = self._usable(edges, from_ctx, to_ctx)
                if fn is None:
                    continue
                parents[nxt] = (cur, fn)
                if nxt is to_cls:
                    chain = []
                    node = nxt
                    while parents[node] is not None:
                        prev, f = parents[node]
                        chain.append((f, node))
                        node = prev
                    chain.reverse()
                    return chain
                frontier.append(nxt)
        return None

    def can_convert(self, from_cls: Type[Format], to_cls: Type[Format]) -> bool:
        return self.get_chain(from_cls, to_cls) is not None

    def convert(
        self, fmt: Format, to_cls: Type[Format], context: Optional[Context] = None
    ) -> Format:
        return self.convert_cached(fmt, to_cls, context)[-1]

    def convert_cached(
        self, fmt: Format, to_cls: Type[Format], context: Optional[Context] = None
    ) -> List[Format]:
        """Every intermediate plus the final format, in order
        (``ConvertCached``, converter.h:230-); just ``[fmt]`` if no work
        is needed."""
        from_ctx = fmt.context
        chain = self.get_chain(type(fmt), to_cls, from_ctx, context)
        if chain is None:
            raise ConversionError(type(fmt).__name__, to_cls.__name__)
        out: List[Format] = []
        cur = fmt
        if context is not None and not from_ctx.is_equivalent(context):
            cur = cur.to(context)
            out.append(cur)
        for fn, _cls in chain:
            cur = fn(cur)
            out.append(cur)
        return out or [fmt]


# -- process-wide default graph (ConverterStore analogue) --------------------
_DEFAULT = ConversionGraph()


def default_graph() -> ConversionGraph:
    return _DEFAULT


def register_conversion(from_cls, to_cls, fn, condition=None):
    _DEFAULT.register(from_cls, to_cls, fn, condition)


def can_convert(from_cls, to_cls) -> bool:
    return _DEFAULT.can_convert(from_cls, to_cls)


def convert(fmt, to_cls, context=None, graph: Optional[ConversionGraph] = None):
    return (graph or _DEFAULT).convert(fmt, to_cls, context)


def convert_cached(fmt, to_cls, context=None, graph: Optional[ConversionGraph] = None):
    return (graph or _DEFAULT).convert_cached(fmt, to_cls, context)


def _register_builtin_edges():
    from ..formats.coo import COO
    from ..formats.csc import CSC
    from ..formats.csr import CSR
    from ..formats.dia import DIA
    from ..formats.ell import ELL
    from . import kernels as k

    register_conversion(COO, CSR, k.coo_to_csr)
    register_conversion(CSR, COO, k.csr_to_coo)
    register_conversion(COO, CSC, k.coo_to_csc)
    register_conversion(CSC, COO, k.csc_to_coo)
    register_conversion(CSR, CSC, k.csr_to_csc)
    register_conversion(CSC, CSR, k.csc_to_csr)
    register_conversion(CSR, DIA, k.csr_to_dia)
    register_conversion(DIA, CSR, k.dia_to_csr)
    register_conversion(CSR, ELL, k.csr_to_ell)
    register_conversion(ELL, CSR, k.ell_to_csr)


_register_builtin_edges()
