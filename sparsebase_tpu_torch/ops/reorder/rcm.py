"""Reverse Cuthill–McKee reordering.

Counterpart of ``sparsebase_tpu/ops/reorder/rcm.py`` (reference
``reorder::RCMReorder``, src/sparsebase/reorder/rcm_reorder.cc:22-166). The
reference's visit order is a level-synchronous BFS in which each new level
is ranked by (position of its first-discovering parent, degree, id):
a vertex is enqueued by its earliest parent, and each parent drains its new
children in (degree, id) order (rcm_reorder.cc:125-144). Each component's
order is reversed (rcm_reorder.cc:146-153). Two routes, as in the JAX
package, with different root choices:

* host (CPU tensors): the reference's semantics exactly, in the native
  graphkit library (``native.rcm``) where it is built and
  ``config.use_graphkit`` is on, else ``_rcm_host`` as torch ops. Vertices are
  scanned in id order; an isolated vertex keeps its scan position; each
  other component starts at a pseudo-peripheral root (repeated BFS from the
  scan vertex, jumping to the lowest-degree vertex of the last level until
  the eccentricity stops growing, rcm_reorder.cc:22-81).
* device (the same torch ops on any device; CUDA tensors take it): the JAX
  device route's semantics. The first component's root comes from
  ``peripheral_iters`` rounds of "BFS from the current root, take the
  lowest-degree vertex of the deepest level, lowest id among ties",
  starting at vertex 0; later components start at the lowest unvisited id.

Both routes touch only the frontier's edges and the next level's vertices.
The device route reads one thing back to the host per level step: the size
of the next level and the count of its edges, which size the next step.
It runs on one device from start to end, with no cap on the graph's size.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ...convert.kernels import indptr_from_sorted_rows, sort_by_pairs
from ...formats.csr import CSR
from ..kernels.radix import bits_below
from .base import Reorderer, ranks_from_sort_keys

_MAX = torch.iinfo(torch.int64).max
_KEY_BITS = 63  # a level's rank key packs (run, degree, id) where they fit in these bits


@dataclasses.dataclass
class RCMReorderParams:
    """Empty like the reference's (rcm_reorder.h)."""


def _symmetrized_square(csr: CSR) -> CSR:
    """The pattern A ∪ Aᵀ over ``max(nrows, ncols)`` vertices, duplicates
    kept: both (row, col) and (col, row) of every entry, sorted by (row,
    col) (K5 on CUDA tensors), with the offsets from the sorted rows (K3).
    Rectangular inputs fold row and column ids into one vertex set."""
    n = max(csr.shape)
    row = csr.row_of_nnz()
    col = csr.indices.to(row.dtype)
    sr, sc = sort_by_pairs(torch.cat([row, col]), torch.cat([col, row]), major_bound=n, minor_bound=n)
    return CSR(indptr_from_sorted_rows(sr, n), sc, None, (n, n))


def _expand_frontier(indptr, indices, frontier, total: Optional[int] = None):
    """``(run, neighbour)`` of every edge out of an ordered frontier, in
    frontier order; ``run`` is the frontier index of the edge's source.
    ``total`` is the count of those edges, where the caller knows it."""
    starts = indptr[frontier]
    lens = indptr[frontier + 1] - starts
    if total is None:
        total = int(lens.sum())
    dev = frontier.device
    run = torch.repeat_interleave(torch.arange(frontier.numel(), device=dev), lens, output_size=total)
    base = (starts - (torch.cumsum(lens, 0) - lens))[run]
    return run, indices[base + torch.arange(total, device=dev)]


# -- host route ----------------------------------------------------------------


def _bfs_levels(indptr, indices, root: int, n: int):
    """Distance of every vertex from ``root`` (-1 unreachable), and the
    eccentricity."""
    dist = torch.full((n,), -1, dtype=torch.int64)
    dist[root] = 0
    frontier = torch.tensor([root])
    level = 0
    while frontier.numel():
        _, nbrs = _expand_frontier(indptr, indices, frontier)
        nbrs = torch.unique(nbrs[dist[nbrs] < 0])
        if nbrs.numel() == 0:
            break
        level += 1
        dist[nbrs] = level
        frontier = nbrs
    return dist, level


def _peripheral(indptr, indices, start: int, n: int, degrees) -> int:
    """Pseudo-peripheral root: repeat the BFS, jumping to the lowest-degree
    vertex of the last level (lowest id among ties), until the eccentricity
    stops growing (rcm_reorder.cc:22-81)."""
    r, prev_ecc = start, -1
    while True:
        dist, ecc = _bfs_levels(indptr, indices, r, n)
        if ecc == prev_ecc:
            return r
        prev_ecc = ecc
        last = torch.nonzero(dist == ecc).flatten()
        r = int(last[torch.argmin(degrees[last])])


def _rcm_host(csr: CSR) -> torch.Tensor:
    """The reference's RCM on a symmetric CPU CSR: ``order[v]`` = new id."""
    indptr, indices = csr.indptr.to(torch.int64), csr.indices.to(torch.int64)
    n = csr.nrows
    degrees = indptr[1:] - indptr[:-1]
    live = degrees > 0
    order = torch.full((n,), -1, dtype=torch.int64)
    visited = torch.zeros((n,), dtype=torch.bool)
    counter, i = 0, 0
    while i < n:
        # the next unvisited vertex with edges; the isolated vertices before
        # it keep their scan positions (rcm_reorder.cc:110-116)
        todo = ~visited[i:] & live[i:]
        k = int(torch.argmax(todo.to(torch.uint8)))
        j = i + k if bool(todo[k]) else n
        iso = torch.nonzero(~visited[i:j] & ~live[i:j]).flatten() + i
        order[iso] = counter + torch.arange(iso.numel())
        visited[iso] = True
        counter += iso.numel()
        if j == n:
            break
        root = _peripheral(indptr, indices, j, n, degrees)
        comp_start = counter
        visited[root] = True
        order[root] = counter
        counter += 1
        frontier = torch.tensor([root])
        members = [frontier]
        while True:
            run, nbrs = _expand_frontier(indptr, indices, frontier)
            fresh = ~visited[nbrs]
            run, nbrs = run[fresh], nbrs[fresh]
            if nbrs.numel() == 0:
                break
            nxt, inv = torch.unique(nbrs, return_inverse=True)  # ascending ids
            # earliest discovering parent; the frontier is in position order
            first = torch.full((nxt.numel(),), _MAX, dtype=torch.int64).scatter_reduce_(0, inv, run, "amin")
            # rank by (first parent, degree, id): two stable sorts of the ascending ids
            o = torch.argsort(degrees[nxt], stable=True)
            nxt = nxt[o[torch.argsort(first[o], stable=True)]]
            visited[nxt] = True
            order[nxt] = counter + torch.arange(nxt.numel())
            counter += nxt.numel()
            frontier = nxt
            members.append(nxt)
        # reverse the component over its own range of positions
        comp = torch.cat(members)
        order[comp] = comp_start + counter - 1 - order[comp]
        i = j + 1
    return order.to(torch.int32)


# -- device route --------------------------------------------------------------


class _Graph:
    """A CSR's arrays as the device route reads them, and its count of
    level steps (each makes one host sync)."""

    def __init__(self, csr: CSR):
        self.indptr = csr.indptr.to(torch.int64)
        self.indices = csr.indices.to(torch.int64)
        self.degrees = self.indptr[1:] - self.indptr[:-1]
        self.n = csr.nrows
        self.dev = self.indptr.device
        self.id_bits = bits_below(self.n)
        self.deg_bits = None  # bits of the largest degree, from the first read
        self.deg_id = None  # each vertex's (degree, id) rank key, where both fit beside a run id
        self.steps = 0

    def read(self, *scalars):
        """The one host sync of a level step: the scalars in one copy. The
        first also reads the largest degree, which sizes the rank keys."""
        self.steps += 1
        if self.deg_bits is not None:
            return torch.stack(scalars).tolist()
        *values, top = torch.stack([*scalars, self.degrees.max()]).tolist()
        self.deg_bits = top.bit_length()
        if 2 * self.id_bits + self.deg_bits <= _KEY_BITS:
            self.deg_id = (self.degrees << self.id_bits) | torch.arange(self.n, device=self.dev)
        return values


def _step(g: _Graph, frontier, total: int, visited, owner, ranked: bool):
    """One level: the unvisited neighbours of ``frontier`` (``total`` edges
    out of it), marked visited. Ranked, they come in (first-discovering
    parent, degree, id) order; else in id order. Returns ``(level, size,
    edges out of it)``."""
    if total == 0:
        return None, 0, 0
    run, nbrs = _expand_frontier(g.indptr, g.indices, frontier, total)
    fresh = ~visited[nbrs]
    # a fresh vertex was never a target before (targets join the next level
    # at once), so its owner slot is untouched: the least edge id wins.
    # Visited targets go to the spare slot n.
    slot = torch.where(fresh, nbrs, g.n)
    edge = torch.arange(total, device=g.dev)
    owner.scatter_reduce_(0, slot, edge, "amin")
    first = fresh & (owner[slot] == edge)
    deg = g.degrees[nbrs]
    size, edges = g.read(first.sum(), torch.where(first, deg, 0).sum())
    if size == 0:
        return None, 0, 0
    # edges come in frontier order, so an edge's run is its parent's
    # position rank: sort by (run, degree, id), the non-first edges last
    id_mask = (1 << g.id_bits) - 1
    if not ranked:
        level = torch.sort(torch.where(first, nbrs, _MAX)).values[:size]
    elif g.deg_id is not None:
        key = (run << (g.id_bits + g.deg_bits)) | g.deg_id[nbrs]
        level = torch.sort(torch.where(first, key, _MAX)).values[:size] & id_mask
    else:
        o = torch.argsort(torch.where(first, (deg << 32) | nbrs, _MAX), stable=True)
        o = o[torch.argsort(torch.where(first, run, _MAX)[o], stable=True)]
        level = nbrs[o[:size]]
    # not ``visited[level] = True``: on a CUDA tensor that copies the scalar
    # from pageable host memory, a second sync per step
    visited.index_fill_(0, level, True)
    return level, size, edges


def _bfs_far(g: _Graph, root):
    """The lowest-degree vertex of the deepest BFS level from ``root`` (a
    one-element tensor), lowest id among ties, as a one-element tensor."""
    visited = torch.zeros((g.n,), dtype=torch.bool, device=g.dev)
    owner = torch.full((g.n + 1,), _MAX, dtype=torch.int64, device=g.dev)
    (total,) = g.read(g.degrees[root].sum())
    visited.index_fill_(0, root, True)
    last = frontier = root
    while total > 0:
        frontier, size, total = _step(g, frontier, total, visited, owner, ranked=False)
        if size == 0:
            break
        last = frontier
    deg = g.degrees[last]
    return torch.where(deg == deg.min(), last, _MAX).min().view(1)


def _rcm_device(csr: CSR, peripheral_iters: int = 2, stats: Optional[dict] = None) -> torch.Tensor:
    """The JAX device route's RCM on ``csr``'s own device (out-edges only):
    ``order[v]`` = new id (int32). With ``stats``, ``stats["level_steps"]``
    is set to the count of level steps (seeds included), each one host sync."""
    g = _Graph(csr)
    n = g.n
    if n == 0:
        return torch.empty((0,), dtype=torch.int32, device=g.dev)
    first_root = torch.zeros((1,), dtype=torch.int64, device=g.dev)
    for _ in range(max(int(peripheral_iters), 0)):
        first_root = _bfs_far(g, first_root)
    perm = torch.empty((n,), dtype=torch.int64, device=g.dev)  # position -> vertex
    visited = torch.zeros((n,), dtype=torch.bool, device=g.dev)
    owner = torch.full((n + 1,), _MAX, dtype=torch.int64, device=g.dev)
    counter, comp_start, lowest, frontier, total = 0, 0, 0, None, 0
    while counter < n:
        if frontier is None:
            # seed: the far root first, then the lowest unvisited id
            if counter == 0:
                root = first_root
                (total,) = g.read(g.degrees[root].sum())
            else:
                root = (torch.argmin(visited[lowest:].to(torch.uint8)) + lowest).view(1)
                root_id, total = g.read(root.sum(), g.degrees[root].sum())
                lowest = root_id + 1
            comp_start = counter
            perm[counter:counter + 1] = root
            visited.index_fill_(0, root, True)
            counter += 1
            frontier = root
            continue
        level, size, total = _step(g, frontier, total, visited, owner, ranked=True)
        if size == 0:
            perm[comp_start:counter] = perm[comp_start:counter].flip(0)  # reverse the component
            frontier = None
            continue
        perm[counter:counter + size] = level
        counter += size
        frontier = level
    perm[comp_start:counter] = perm[comp_start:counter].flip(0)
    order = torch.empty((n,), dtype=torch.int32, device=g.dev)
    order[perm] = torch.arange(n, dtype=torch.int32, device=g.dev)
    if stats is not None:
        stats["level_steps"] = g.steps
    return order


def _rcm_impl(formats, params) -> torch.Tensor:
    csr: CSR = formats[0]
    if csr.indptr.device.type != "cpu":
        order = _rcm_device(_symmetrized_square(csr))
    else:
        from ... import native

        if native.available():
            # graphkit folds and symmetrizes itself, the exact mirror of the host route
            order = native.rcm(csr.nrows, csr.ncols, csr.indptr, csr.indices).to(torch.int32)
        else:
            order = _rcm_host(_symmetrized_square(csr))
    if max(csr.shape) != csr.nrows:
        # compress the folded order to a row permutation: rank the first
        # nrows vertices by their positions (a stable sort)
        return ranks_from_sort_keys(order[: csr.nrows], key_bits=bits_below(max(csr.shape)))
    return order


class RCMReorder(Reorderer):
    def __init__(self, params: Optional[RCMReorderParams] = None):
        super().__init__("rcm_reorder")
        self.params = params or RCMReorderParams()
        self.register((CSR,), _rcm_impl)
