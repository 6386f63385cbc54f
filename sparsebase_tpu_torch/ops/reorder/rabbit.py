"""Rabbit-order-style community reordering.

Counterpart of ``sparsebase_tpu/ops/reorder/rabbit.py`` (reference
``reorder::RabbitReorder``, src/sparsebase/reorder/rabbit_reorder.cc:25-50,
which wraps the rabbit_order library's ``aggregate`` and ``compute_perm``),
with the same structure:

* one pass over the vertices in ascending degree: each vertex merges into
  the adjacent community of largest modularity gain
  ``w(v, c) / W - deg(v) deg(c) / (2 W^2)``, where that gain is positive;
* a depth-first walk of the merge forest gives the leaves consecutive new
  ids (the ``compute_perm`` analogue).

A host algorithm by the reference's own design (``_host.py``; the
aggregation is a sequential union-find): graphkit's ``rabbit`` where it
builds and ``config.use_graphkit`` is on, else ``_rabbit_host``, the JAX
package's Python route line for line; the two give the same order.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

from ...formats.csr import CSR
from ._host import host_arrays, to_order
from .base import Reorderer


@dataclasses.dataclass
class RabbitReorderParams:
    """The reference's rabbit reorder takes no parameters."""


def _rabbit_host(indptr, indices, n):
    """The Python route on int64 CSR arrays: ``order[v]`` = new id."""
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    W = max(len(row), 1)
    # union-find whose merges keep their children (the dendrogram forest)
    parent = np.arange(n, dtype=np.int64)
    children = defaultdict(list)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    # community adjacency and degree
    com_adj = [defaultdict(float) for _ in range(n)]
    for u, v in zip(row.tolist(), indices.tolist()):
        if u != v:
            com_adj[u][v] += 1.0
    com_deg = np.array([sum(a.values()) for a in com_adj])

    order_by_deg = np.argsort(np.diff(indptr), kind="stable")
    for v in order_by_deg.tolist():
        rv = find(v)
        if rv != v:
            continue  # already merged into a community
        adj = com_adj[rv]
        if not adj:
            continue
        best_gain, best_c = 0.0, -1
        deg_v = com_deg[rv]
        for u, w in list(adj.items()):
            ru = find(u)
            if ru == rv:
                continue
            gain = w / W - (deg_v * com_deg[ru]) / (2.0 * W * W)
            if gain > best_gain:
                best_gain, best_c = gain, ru
        if best_c >= 0:
            # merge v's community into best_c
            parent[rv] = best_c
            children[best_c].append(rv)
            tgt = com_adj[best_c]
            for u, w in adj.items():
                ru = find(u)
                if ru != best_c:
                    tgt[ru] += w
            com_adj[rv] = defaultdict(float)
            com_deg[best_c] += deg_v

    # DFS over the merge forest: roots in ascending id, children in merge
    # order, leaves numbered in visit order
    order = np.empty(n, dtype=np.int64)
    counter = 0
    visited = np.zeros(n, bool)
    for root in range(n):
        if find(root) != root or visited[root]:
            continue
        stack = [root]
        while stack:
            x = stack.pop()
            if visited[x]:
                continue
            visited[x] = True
            order[x] = counter
            counter += 1
            stack.extend(reversed(children[x]))
    return order


def _rabbit_impl(formats, params):
    csr: CSR = formats[0]
    indptr, indices = host_arrays(csr)
    from ... import native

    if native.available():
        return to_order(native.rabbit(csr.nrows, indptr, indices), csr)
    return to_order(_rabbit_host(indptr, indices, csr.nrows), csr)


class RabbitReorder(Reorderer):
    def __init__(self, params: RabbitReorderParams | None = None):
        super().__init__("rabbit_reorder")
        self.params = params or RabbitReorderParams()
        self.register((CSR,), _rabbit_impl)
