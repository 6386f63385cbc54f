"""SlashBurn reordering: repeated removal of k hubs, spokes to the back.

Counterpart of ``sparsebase_tpu/ops/reorder/slashburn.py`` (reference
``reorder::SlashburnReorder``, src/sparsebase/reorder/slashburn_reorder.cc;
params slashburn_reorder.h:14-23), with its layout:

* the graph is symmetrized (the A ∪ Aᵀ pattern, slashburn_reorder.cc:330-360);
* components outside the giant one ("spokes") go to the **back**, the
  smallest first from the end ((size, root) ascending);
* the giant component loops: the k highest-degree hubs go to the **front**
  in descending degree (``greedy`` recounts the degrees after each removal),
  the components are found again, the new spokes go to the back
  (``hub_order`` groups them by their first hub), until the giant component
  has fewer than k vertices, which then go to the back.

Within a spoke the order is ascending vertex id, where the reference
visits in reversed DFS order: the JAX package's documented redesign, kept
here, so the per-round hub sets (greedy) and the round-0 hub degrees match
the reference's goldens, not the whole order.

A host algorithm by the reference's own design (``_host.py``): graphkit's
``slashburn`` where it builds and ``config.use_graphkit`` is on, else
``_slashburn_host`` in numpy, the JAX package's host route line for line;
the two give the same order. A CUDA CSR is copied to the host once.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...formats.csr import CSR
from ._host import host_arrays, to_order
from .base import Reorderer


@dataclasses.dataclass
class SlashburnReorderParams:
    k_size: int = 64
    greedy: bool = True
    hub_order: bool = False


def _symmetrize_pattern(indptr, indices, n):
    """The union of the A and Aᵀ patterns, without duplicates."""
    row = np.repeat(np.arange(n, dtype=indices.dtype), np.diff(indptr))
    ur = np.concatenate([row, indices])
    uc = np.concatenate([indices, row])
    keys = ur.astype(np.int64) * n + uc.astype(np.int64)
    uniq = np.unique(keys)
    sr = (uniq // n).astype(indices.dtype)
    sc = (uniq % n).astype(indices.dtype)
    sp = np.concatenate([[0], np.cumsum(np.bincount(sr, minlength=n))]).astype(np.int64)
    return sp, sc


def _cc_labels(indptr, indices, active):
    """Min-label propagation over the active subgraph; inactive vertices -1."""
    n = active.shape[0]
    labels = np.where(active, np.arange(n, dtype=np.int64), -1)
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    live = active[row] & active[indices]
    r, c = row[live], indices[live]
    while True:
        new = labels.copy()
        np.minimum.at(new, c, labels[r])
        np.minimum.at(new, r, labels[c])
        new = np.where(active, new, -1)
        if np.array_equal(new, labels):
            return labels
        labels = new


def _active_degrees(indptr, indices, active):
    row = np.repeat(np.arange(active.shape[0], dtype=np.int64), np.diff(indptr))
    live = active[row] & active[indices]
    return np.bincount(row[live], minlength=active.shape[0])


def _place_spokes(order, labels, active, gcc_label, back_cursor, hub_of=None):
    """Give back positions to every active component but the giant one.

    The components, ascending by (hub index, size, least label), take the
    highest free positions first (the reference's min-heap and orderCC
    placement). Returns ``(new back_cursor, updated active)``."""
    spoke_mask = active & (labels != gcc_label) & (labels >= 0)
    if not spoke_mask.any():
        return back_cursor, active
    verts = np.nonzero(spoke_mask)[0]
    comp = labels[verts]
    uniq, inv = np.unique(comp, return_inverse=True)
    sizes = np.bincount(inv)
    hub_key = np.zeros(len(uniq), np.int64)
    if hub_of is not None:
        hub_key = np.full(len(uniq), np.iinfo(np.int64).max)
        np.minimum.at(hub_key, inv, hub_of[verts])
    comp_order = np.lexsort((uniq, sizes, hub_key))  # ascending
    # the component taken first gets the block nearest the end
    rank_of_comp = np.zeros(len(uniq), np.int64)
    rank_of_comp[comp_order] = np.arange(len(uniq))
    ordered_sizes = sizes[comp_order]
    before = np.concatenate([[0], np.cumsum(ordered_sizes)[:-1]])  # vertices of the components taken earlier
    starts = back_cursor - before - ordered_sizes + 1
    # within a component: ascending id from the block's start; the vertices
    # in (rank, id) order, so a component's first sits at ``before[rank]``
    sort_key = np.lexsort((verts, rank_of_comp[inv]))
    seq = verts[sort_key]
    comp_rank_seq = rank_of_comp[inv][sort_key]
    offsets = np.arange(seq.shape[0]) - before[comp_rank_seq]
    order[seq] = starts[comp_rank_seq] + offsets
    active = active & ~spoke_mask
    return back_cursor - int(ordered_sizes.sum()), active


def _slashburn_host(indptr, indices, n, params: SlashburnReorderParams):
    """The numpy route on int64 CSR arrays: ``order[v]`` = new id (int64)."""
    k = max(int(params.k_size), 1)
    sp, sc = _symmetrize_pattern(indptr, indices, n)

    order = np.full(n, -1, np.int64)
    active = np.ones(n, bool)
    front = 0
    back = n - 1

    # first spokes: everything outside the giant component
    labels = _cc_labels(sp, sc, active)
    sizes = np.bincount(labels[labels >= 0], minlength=n)
    gcc = int(np.argmax(sizes))
    back, active = _place_spokes(order, labels, active, gcc, back)

    while True:
        count = int(active.sum())
        if count == 0:
            break
        if count < k:
            # the rest of the giant component goes to the back, ascending id
            verts = np.nonzero(active)[0]
            order[verts] = back - count + 1 + np.arange(count)
            back -= count
            break
        degrees = _active_degrees(sp, sc, active)
        degrees = np.where(active, degrees, -1)
        hub_of = np.full(n, np.iinfo(np.int64).max, np.int64)
        if params.greedy:
            hubs = np.empty(k, np.int64)
            for i in range(k):
                h = int(np.argmax(degrees))
                hubs[i] = h
                degrees[h] = -1
                nbrs = sc[sp[h] : sp[h + 1]]
                degrees[nbrs[active[nbrs] & (degrees[nbrs] > 0)]] -= 1
                active[h] = False
        else:
            # descending degree, ascending id among ties
            hubs = np.lexsort((np.arange(n), -degrees))[:k]
            active[hubs] = False
        order[hubs] = front + np.arange(k)
        front += k
        if params.hub_order:
            for i, h in enumerate(hubs):
                nbrs = sc[sp[h] : sp[h + 1]]
                hub_of[nbrs] = np.minimum(hub_of[nbrs], i)
        labels = _cc_labels(sp, sc, active)
        live = labels[labels >= 0]
        if live.size == 0:
            break
        sizes = np.bincount(live, minlength=n)
        gcc = int(np.argmax(sizes))
        back, active = _place_spokes(order, labels, active, gcc, back, hub_of if params.hub_order else None)
        if int(sizes[gcc]) < k:
            verts = np.nonzero(active)[0]
            order[verts] = back - verts.size + 1 + np.arange(verts.size)
            back -= verts.size
            break
    return order


def _slashburn_impl(formats, params: SlashburnReorderParams):
    csr: CSR = formats[0]
    indptr, indices = host_arrays(csr)
    from ... import native

    if native.available():
        order = native.slashburn(csr.nrows, indptr, indices, max(int(params.k_size), 1), params.greedy,
                                 params.hub_order)
    else:
        order = _slashburn_host(indptr, indices, csr.nrows, params)
    return to_order(order, csr)


class SlashburnReorder(Reorderer):
    def __init__(self, k_size: int = 64, greedy: bool = True, hub_order: bool = False):
        super().__init__("slashburn_reorder")
        self.params = SlashburnReorderParams(k_size, greedy, hub_order)
        self.register((CSR,), _slashburn_impl)
