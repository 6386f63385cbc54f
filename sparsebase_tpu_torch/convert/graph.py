"""Conversion graph: registry + BFS path-finding + chain application.

Counterpart of ``sparsebase_tpu/convert/graph.py`` (reference
src/sparsebase/converter/converter.h:65-350 — ``ConversionMap``
registration :124-128, ``ConversionBFS`` :138-195,
``GetConversionChain`` :197-213, ``ApplyConversionChain`` :253-). Edges
are keyed on format classes with an optional ``condition(from_ctx,
to_ctx)``; a placement move (``Format.to``) runs before the chain, so each
conversion runs where its result must live, unless a step of the chain
needs the target context itself (:class:`ContextConversion`: CSR →
ShardedCSR needs the mesh) and places its result. PyTorch runs eagerly, so
a chain step is a direct call, inside the host span
``sbtorch:convert:<From>-><To>`` (a move: ``sbtorch:convert:<From>:to_context``).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, Optional, Tuple, Type

from ..context import Context
from ..formats.base import Format
from ..utils.exceptions import ConversionError
from ..utils.tracing import host_span

ConversionFn = Callable[[Format], Format]
Condition = Callable[[Optional[Context], Optional[Context]], bool]


class ContextConversion:
    """Marks a conversion whose implementation needs the *target context*
    (CSR → ShardedCSR needs the mesh): called as ``fn(fmt, to_context)``,
    it performs the placement itself, so the chain executor does not move
    the input first (the reference's context-conditional CUDA edges,
    converter_order_two.cc:288-341, generalised to meshes)."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, fmt, to_ctx=None):
        return self.fn(fmt, to_ctx)


class EagerConversion:
    """Marks a conversion whose output's shapes depend on the data
    (CSR → ELL sizes its width to the largest degree). The JAX package
    must not trace such a step; here every step runs eagerly, so the mark
    records the kind and changes nothing."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, fmt):
        return self.fn(fmt)


def apply_edge(fn: ConversionFn, fmt: Format, to_cls: Type[Format], context: Optional[Context] = None) -> Format:
    """One step of a chain, ``fmt`` to ``to_cls``, inside its host span; a
    :class:`ContextConversion` is handed ``context``."""
    with host_span(f"sbtorch:convert:{type(fmt).__name__}->{to_cls.__name__}"):
        return fn(fmt, context) if isinstance(fn, ContextConversion) else fn(fmt)


def move(fmt: Format, context: Context) -> Format:
    """``fmt.to(context)`` inside its host span."""
    with host_span(f"sbtorch:convert:{type(fmt).__name__}:to_context"):
        return fmt.to(context)


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
        has_ctx_edge = any(isinstance(fn, ContextConversion) for fn, _ in chain)
        if context is not None and not from_ctx.is_equivalent(context) and not has_ctx_edge:
            cur = move(cur, context)
            out.append(cur)
        for fn, cls in chain:
            cur = apply_edge(fn, cur, cls, context)
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
    register_conversion(CSR, ELL, EagerConversion(k.csr_to_ell))
    register_conversion(ELL, CSR, EagerConversion(k.ell_to_csr))


_MESH_EDGES_DONE = False


def _register_mesh_edges():
    """Mesh-placement edges: ShardedCSR joins the conversion graph, gated on
    the target being a MeshContext. Called by ``sparsebase_tpu_torch.parallel``
    on import, the only way user code can name ShardedCSR."""
    global _MESH_EDGES_DONE
    if _MESH_EDGES_DONE:
        return
    _MESH_EDGES_DONE = True
    from ..context import MeshContext
    from ..formats.csr import CSR
    from ..parallel.sharded import ShardedCSR

    def to_sharded(csr, to_ctx):
        return ShardedCSR.from_csr(csr, to_ctx.mesh, axis=to_ctx.axis)

    def to_csr(sh, to_ctx):
        out = sh.to_csr()
        if to_ctx is not None:
            out = out.to(to_ctx)
        return out

    register_conversion(
        CSR,
        ShardedCSR,
        ContextConversion(to_sharded),
        condition=lambda f, t: isinstance(t, MeshContext),
    )
    register_conversion(ShardedCSR, CSR, ContextConversion(to_csr))


_register_builtin_edges()
