"""Nested-dissection fill-reducing ordering (METIS_NodeND-equivalent).

Counterpart of ``sparsebase_tpu/ops/reorder/nested_dissection.py``
(reference ``reorder::MetisReorder``, src/sparsebase/reorder/
metis_reorder.cc:26-60, which wraps ``METIS_NodeND``; params
metis_reorder.h:15):

* the graph is bisected recursively (region growing and refinement,
  ``ops/partition/multilevel.py``);
* the separator is the smaller side of the cut's boundary (a cheap vertex
  cover of the cut edges);
* the order is [left block, right block, separator], recursing into the
  blocks; blocks of at most ``leaf_size`` vertices, and bisections that
  leave a side empty, take minimum degree (``amd._min_degree_order``).

``MetisReorderParams`` keeps every field of the reference's; ``ctype``,
``rtype``, ``nseps``, ``pfactor`` and ``compress`` are accepted and unused.

A host algorithm by the reference's own design (``_host.py``; the
recursion is sequential): graphkit's ``nested_dissection`` where it builds
and ``config.use_graphkit`` is on, else ``_nested_dissection`` in numpy,
the JAX package's route line for line, with a numpy ``Generator`` seeded
by ``seed`` and drawn in the same order; the two give the same order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...formats.csr import CSR
from ..partition.multilevel import _refine, _region_grow, _symmetrize
from ._host import host_arrays, to_order
from .amd import _min_degree_order
from .base import Reorderer


@dataclasses.dataclass
class MetisReorderParams:
    ctype: str = "shem"
    rtype: str = "sep1sided"
    nseps: int = 1
    niter: int = 10
    seed: int = 42
    ufactor: int = 30
    pfactor: int = 0
    compress: int = 1
    leaf_size: int = 64


def _subgraph(indptr, indices, vertices, n):
    """The CSR arrays of the subgraph induced by ``vertices`` (local ids)."""
    sub_id = np.full(n, -1, np.int64)
    sub_id[vertices] = np.arange(len(vertices))
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    mask = (sub_id[row] >= 0) & (sub_id[indices] >= 0)
    sr, sc = sub_id[row[mask]], sub_id[indices[mask]]
    order = np.argsort(sr, kind="stable")
    sip = np.concatenate([[0], np.cumsum(np.bincount(sr, minlength=len(vertices)))]).astype(np.int64)
    return sip, sc[order]


def _min_degree_block(sip, six, m):
    """A small block by exact minimum degree; a block of more than 2,000
    vertices (the exact algorithm is superquadratic under fill) by
    ascending degree."""
    if m > 2000:
        return np.argsort(np.diff(sip), kind="stable")
    return _min_degree_order(sip, six, m, np.inf)


def _nested_dissection(indptr, indices, n, params: MetisReorderParams):
    """The numpy route on a symmetric pattern: ``order[v]`` = new id (int64)."""
    rng = np.random.default_rng(params.seed)
    result = np.empty(n, dtype=np.int64)  # result[pos] = vertex
    cursor = [0]

    def emit(vertices):
        result[cursor[0] : cursor[0] + len(vertices)] = vertices
        cursor[0] += len(vertices)

    def recurse(vertices):
        m = len(vertices)
        if m == 0:
            return
        sip, six = _subgraph(indptr, indices, vertices, n)
        if m <= params.leaf_size:
            emit(vertices[_min_degree_block(sip, six, m)])
            return
        ew = np.ones(len(six), np.float64)
        vw = np.ones(m, np.float64)
        cap = (1.0 + params.ufactor / 1000.0) * m / 2
        two = _region_grow(sip, six, ew, vw, 2, rng, cap)
        two = _refine(sip, six, ew, vw, two, 2, cap, rounds=params.niter)
        # the boundary vertices of each side
        row = np.repeat(np.arange(m, dtype=np.int64), np.diff(sip))
        cutmask = two[row] != two[six]
        b0 = np.unique(row[cutmask & (two[row] == 0)])
        b1 = np.unique(row[cutmask & (two[row] == 1)])
        sep_local = b0 if len(b0) <= len(b1) else b1
        sep_set = np.zeros(m, bool)
        sep_set[sep_local] = True
        left = vertices[(two == 0) & ~sep_set]
        right = vertices[(two == 1) & ~sep_set]
        if len(left) == 0 or len(right) == 0:
            # the bisection left a side empty: minimum degree on the block
            emit(vertices[_min_degree_block(sip, six, m)])
            return
        recurse(left)
        recurse(right)
        emit(vertices[sep_set])

    recurse(np.arange(n, dtype=np.int64))
    order = np.empty(n, dtype=np.int64)
    order[result] = np.arange(n)
    return order


def _metis_reorder_impl(formats, params: MetisReorderParams):
    csr: CSR = formats[0]
    indptr, indices = host_arrays(csr)
    from ... import native

    if native.available():
        return to_order(native.nested_dissection(csr.nrows, indptr, indices, params.seed, params.ufactor,
                                                 params.niter, params.leaf_size), csr)
    sip, six, _ = _symmetrize(indptr, indices, np.ones(csr.nnz, np.float64), csr.nrows)
    return to_order(_nested_dissection(sip, six, csr.nrows, params), csr)


class MetisReorder(Reorderer):
    """Nested-dissection reorderer (the ``METIS_NodeND`` API)."""

    def __init__(self, **kw):
        super().__init__("metis_reorder")
        self.params = MetisReorderParams(**kw)
        self.register((CSR,), _metis_reorder_impl)
