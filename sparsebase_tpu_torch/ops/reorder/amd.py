"""Minimum-degree fill-reducing ordering (AMD-equivalent).

Counterpart of ``sparsebase_tpu/ops/reorder/amd.py`` (reference
``reorder::AMDReorder``, src/sparsebase/reorder/amd_reorder.cc:29-57, which
wraps SuiteSparse ``amd_l_order``; params amd_reorder.h:27 {dense,
aggressive}). The elimination runs on a quotient graph with element
absorption and a lazy min-heap (degrees recounted on pop), the structure
AMD builds, with exact external degrees in place of AMD's bounds.

``dense`` (as AMD_DENSE): rows of degree above ``dense * sqrt(n)`` go last,
in id order. ``aggressive`` (AMD_AGGRESSIVE): an element whose live
variables all lie in the new pivot element's list is absorbed even when it
was not adjacent to the pivot; off, only the pivot's own elements are.

A host algorithm by the reference's own design (``_host.py``; elimination
is sequential): graphkit's ``amd`` where it builds and
``config.use_graphkit`` is on, else ``_min_degree_order`` in Python (heapq
and sets), the JAX package's route line for line; the two give the same
order.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from ...formats.csr import CSR
from ._host import host_arrays, to_order
from .base import Reorderer


@dataclasses.dataclass
class AMDReorderParams:
    dense: float = 10.0  # AMD_DEFAULT_DENSE
    aggressive: bool = True


def _min_degree_order(indptr, indices, n, dense_threshold, aggressive=True):
    """Quotient-graph minimum-degree elimination; returns the elimination
    order ``perm[new] = old`` (int64). ``aggressive`` also absorbs the
    elements whose live variables all lie in the new element's list."""
    # adjacency sets (symmetrized, no self-loops)
    A = [set() for _ in range(n)]
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    for u, v in zip(row.tolist(), indices.tolist()):
        if u != v:
            A[u].add(v)
            A[v].add(u)
    E = [set() for _ in range(n)]  # elements adjacent to each variable
    L = {}  # element -> variable set
    eliminated = np.zeros(n, bool)
    dense_mask = np.array([len(A[v]) for v in range(n)]) > dense_threshold
    heap = []
    for v in range(n):
        if not dense_mask[v]:
            heapq.heappush(heap, (len(A[v]), v))
    perm = []
    next_element = n  # element ids start after the variables

    def current_degree(v):
        nbrs = set(A[v])
        for e in E[v]:
            if e in L:
                nbrs |= L[e]
        nbrs.discard(v)
        return len([u for u in nbrs if not eliminated[u]]), nbrs

    count = int((~dense_mask).sum())
    while len(perm) < count:
        d, v = heapq.heappop(heap)
        if eliminated[v] or dense_mask[v]:
            continue
        true_d, nbrs = current_degree(v)
        if true_d > d:
            heapq.heappush(heap, (true_d, v))
            continue
        # eliminate v
        eliminated[v] = True
        perm.append(v)
        Lv = {u for u in nbrs if not eliminated[u]}
        if Lv:
            e_new = next_element
            next_element += 1
            L[e_new] = Lv
            for u in Lv:
                A[u].discard(v)
                A[u] -= Lv  # edges inside the clique are covered by e_new
                # absorb v's elements (their variables are in L[e_new])
                for e in E[v]:
                    if e in E[u]:
                        E[u].discard(e)
                E[u].add(e_new)
                heapq.heappush(heap, (max(len(A[u]) + sum(1 for e in E[u] if e in L) - 1, 0), u))
            for e in E[v]:
                L.pop(e, None)
            if aggressive:
                # a live element next to the clique whose live members all
                # lie in Lv is covered by e_new: drop it (the E lists are
                # pruned lazily through ``e in L``)
                cand = set()
                for u in Lv:
                    cand |= {e for e in E[u] if e in L and e != e_new}
                for e in cand:
                    live = {x for x in L[e] if not eliminated[x]}
                    if live <= Lv:
                        L.pop(e, None)
        else:
            for e in E[v]:
                L.pop(e, None)
        A[v] = set()
        E[v] = set()
    # dense rows last, ascending id (AMD's dense-row handling)
    perm.extend(np.nonzero(dense_mask)[0].tolist())
    return np.array(perm, dtype=np.int64)


def _amd_impl(formats, params: AMDReorderParams):
    csr: CSR = formats[0]
    n = csr.nrows
    indptr, indices = host_arrays(csr)
    thr = params.dense * np.sqrt(max(n, 1)) if params.dense > 0 else np.inf
    from ... import native

    if native.available():
        return to_order(native.amd(n, indptr, indices, thr, params.aggressive), csr)
    perm = _min_degree_order(indptr, indices, n, thr, aggressive=params.aggressive)  # perm[new] = old
    order = np.empty(n, dtype=np.int64)
    order[perm] = np.arange(n)
    return to_order(order, csr)


class AMDReorder(Reorderer):
    def __init__(self, dense: float = 10.0, aggressive: bool = True):
        super().__init__("amd_reorder")
        self.params = AMDReorderParams(dense, aggressive)
        self.register((CSR,), _amd_impl)
