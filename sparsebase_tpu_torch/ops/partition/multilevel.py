"""Multilevel graph partitioning: the helpers nested dissection needs.

Counterpart of part of ``sparsebase_tpu/ops/partition/multilevel.py``
(reference ``partition::MetisPartition``, src/sparsebase/partition/
metis_partition.cc:33-90): the pattern symmetrization (``_symmetrize``),
the initial partition by weighted region growing (``_region_grow``) and
the boundary refinement (``_refine``), on weighted CSR arrays in numpy on
the host. ``ops/reorder/nested_dissection.py``'s numpy route bisects with
them. They draw from a numpy ``Generator`` in the JAX package's order, so
that a seed gives the JAX package's partition. The coarsening and the
partitioners themselves come with ROADMAP queue 1, item 8.
"""

from __future__ import annotations

import heapq

import numpy as np


def _symmetrize(indptr, indices, ewts, n):
    """``(indptr, indices, weights)`` of A + Aᵀ without self-loops, a
    repeated entry's weights summed."""
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    ur = np.concatenate([row, indices])
    uc = np.concatenate([indices, row])
    uw = np.concatenate([ewts, ewts])
    keep = ur != uc
    ur, uc, uw = ur[keep], uc[keep], uw[keep]
    key = ur * n + uc
    order = np.argsort(key, kind="stable")
    key_s, uw_s = key[order], uw[order]
    uniq_mask = np.ones(len(key_s), bool)  # the JAX package's [True, ...] fails on no entries
    uniq_mask[1:] = key_s[1:] != key_s[:-1]
    uniq_keys = key_s[uniq_mask]
    seg = np.cumsum(uniq_mask) - 1
    w = np.zeros(len(uniq_keys), uw.dtype)
    np.add.at(w, seg, uw_s)
    r = (uniq_keys // n).astype(np.int64)
    c = (uniq_keys % n).astype(np.int64)
    ip = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=n))]).astype(np.int64)
    return ip, c, w


def _region_grow(indptr, indices, ewts, vwts, k, rng, cap):
    """The initial partition: weighted BFS growth of ``k`` parts from random
    seeds, the lightest part growing first; vertices never reached go to
    the lightest part."""
    n = len(indptr) - 1
    labels = np.full(n, -1, np.int64)
    sizes = np.zeros(k, np.float64)
    seeds = rng.choice(n, size=min(k, n), replace=False)
    frontier = [list() for _ in range(k)]
    for p, s in enumerate(seeds):
        labels[s] = p
        sizes[p] += vwts[s]
        frontier[p].extend(indices[indptr[s] : indptr[s + 1]].tolist())
    heap = [(sizes[p], p) for p in range(k)]
    heapq.heapify(heap)
    stall = 0
    while (labels < 0).any() and stall < 2 * k:
        _, p = heapq.heappop(heap)
        grew = False
        while frontier[p]:
            v = frontier[p].pop()
            if labels[v] < 0:
                labels[v] = p
                sizes[p] += vwts[v]
                frontier[p].extend(indices[indptr[v] : indptr[v + 1]].tolist())
                grew = True
                break
        if not grew:
            stall += 1
        else:
            stall = 0
        heapq.heappush(heap, (sizes[p], p))
    for v in np.nonzero(labels < 0)[0]:
        p = int(np.argmin(sizes))
        labels[v] = p
        sizes[p] += vwts[v]
    return labels


def _refine(indptr, indices, ewts, vwts, labels, k, cap, rounds=8, rng=None):
    """Weighted boundary refinement: moves of positive gain always, moves of
    zero gain toward a smaller part or by a coin flip (to leave plateaus);
    the labelling of the least cut is kept."""
    n = len(indptr) - 1
    rng = rng or np.random.default_rng(0x9E3779B9)
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))

    def cut(lab):
        return float(ewts[lab[row] != lab[indices]].sum())

    best_lab = labels.copy()
    best_cut = cut(labels)
    for _ in range(rounds * 3):
        aff = np.zeros((n, k), np.float64)
        np.add.at(aff, (row, labels[indices]), ewts)
        sizes = np.zeros(k, np.float64)
        np.add.at(sizes, labels, vwts)
        cur = aff[np.arange(n), labels]
        # no moves into full parts
        full = sizes + 0.0 >= cap
        aff_masked = aff.copy()
        aff_masked[:, full] = -np.inf
        aff_masked[np.arange(n), labels] = -np.inf
        best = np.argmax(aff_masked, axis=1)
        gain = aff_masked[np.arange(n), best] - cur
        zero_ok = (gain == 0) & ((sizes[best] + vwts < sizes[labels]) | (rng.random(n) < 0.3))
        movers = np.nonzero((gain > 0) | zero_ok)[0]
        if movers.size == 0:
            break
        # accept in gain order, the sizes kept up to date
        moved = 0
        for v in movers[np.argsort(-gain[movers])]:
            tgt = int(best[v])
            if sizes[tgt] + vwts[v] <= cap and labels[v] != tgt:
                sizes[labels[v]] -= vwts[v]
                sizes[tgt] += vwts[v]
                labels[v] = tgt
                moved += 1
        c = cut(labels)
        if c < best_cut:
            best_cut = c
            best_lab = labels.copy()
        if moved == 0:
            break
    return best_lab
