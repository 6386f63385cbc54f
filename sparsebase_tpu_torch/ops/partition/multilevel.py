"""Multilevel k-way graph partitioning (METIS-equivalent).

Counterpart of ``sparsebase_tpu/ops/partition/multilevel.py`` (reference
``partition::MetisPartition``, src/sparsebase/partition/
metis_partition.cc:33-90, which wraps METIS ``METIS_PartGraphKway`` and
``METIS_PartGraphRecursive``; 17-field params metis_partition.h:17-37):

* coarsening: randomized heavy-edge matching (every vertex proposes to its
  heaviest unmatched neighbour; proposals returned contract), a few rounds
  per level;
* initial partition: weighted BFS region growing from ``k`` seeds on the
  coarsest graph (``ptype="kway"``), or recursive bisection (``"rb"``);
* uncoarsening: the labels projected back and refined at every level
  (boundary moves under a vertex-weight capacity).

A host algorithm by the reference's own design (each level depends on the
one before): ``ptype="kway"`` runs graphkit's ``partition_kway`` where it
builds and ``config.use_graphkit`` is on; every other case runs here in
numpy on weighted CSR arrays, the JAX package's route line for line, with a
numpy ``Generator`` seeded by ``seed`` and drawn in the same order, so that
one seed gives the JAX package's labels. A CUDA CSR is copied to the host
once; the labels go back to the input's device as int32. Nested
dissection's numpy route (``ops/reorder/nested_dissection.py``) bisects with
``_region_grow`` and ``_refine``.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from ...formats.csr import CSR
from .base import Partitioner


@dataclasses.dataclass
class MetisPartitionParams:
    """The fields of MetisPartitionParams (metis_partition.h:17-37); options
    without a native equivalent are accepted and ignored."""

    num_partitions: int = 2
    ptype: str = "kway"  # "kway" | "rb"
    objtype: str = "cut"  # "cut" | "vol" (vol is taken as cut)
    ctype: str = "shem"  # coarsening: heavy-edge matching
    rtype: str = "fm"
    nseps: int = 1
    niter: int = 10
    ncuts: int = 1
    seed: int = 42
    minconn: int = 0
    no2hop: int = 0
    contig: int = 0
    compress: int = 0
    ccorder: int = 0
    pfactor: int = 0
    ufactor: int = 30  # allowed imbalance = 1 + ufactor/1000
    numbering: int = 0


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


def _heavy_edge_matching(indptr, indices, ewts, vwts, rng, max_vwt):
    """``match[v]`` = its partner, or ``v``: randomized heavy-edge matching
    by proposals that must be returned, at most four rounds."""
    n = len(indptr) - 1
    match = np.full(n, -1, np.int64)
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    for _round in range(4):
        unmatched = match < 0
        if not unmatched.any():
            break
        # candidate edges: both ends unmatched, the contracted weight under the cap
        ok = unmatched[row] & unmatched[indices] & (vwts[row] + vwts[indices] <= max_vwt)
        if not ok.any():
            break
        # propose to the heaviest eligible neighbour (ties broken by a random jitter)
        jitter = rng.random(len(ewts)) * 0.01
        score = np.where(ok, ewts + jitter, -np.inf)
        best = np.full(n, -1, np.int64)
        best_score = np.full(n, -np.inf)
        np.maximum.at(best_score, row, score)
        is_best = score >= best_score[row] - 1e-12
        cand = np.where(ok & is_best)[0]
        best[row[cand]] = indices[cand]
        # proposals returned
        has = best >= 0
        v = np.nonzero(has)[0]
        partner = best[v]
        recip = best[partner] == v
        a, b = v[recip], partner[recip]
        lo = np.minimum(a, b)
        hi = np.maximum(a, b)
        match[lo] = hi
        match[hi] = lo
    match[match < 0] = np.nonzero(match < 0)[0]
    return match


def _contract(indptr, indices, ewts, vwts, match):
    """The coarse graph of a matching: one vertex per matched pair (weights
    summed), repeated coarse edges merged with their weights summed, no
    self-loops; and ``cmap[v]`` = the coarse vertex of ``v``."""
    n = len(indptr) - 1
    rep = np.minimum(np.arange(n), match)
    uniq, cmap = np.unique(rep, return_inverse=True)
    nc = len(uniq)
    cvwts = np.zeros(nc, vwts.dtype)
    np.add.at(cvwts, cmap, vwts)
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    cr, cc = cmap[row], cmap[indices]
    keep = cr != cc
    cr, cc, w = cr[keep], cc[keep], ewts[keep]
    key = cr * nc + cc
    order = np.argsort(key, kind="stable")
    key_s, w_s = key[order], w[order]
    if len(key_s):
        uniq_mask = np.concatenate([[True], key_s[1:] != key_s[:-1]])
        seg = np.cumsum(uniq_mask) - 1
        uniq_keys = key_s[uniq_mask]
        cw = np.zeros(len(uniq_keys), w.dtype)
        np.add.at(cw, seg, w_s)
    else:
        uniq_keys = key_s
        cw = np.zeros(0, w.dtype)
    r2 = (uniq_keys // nc).astype(np.int64)
    c2 = (uniq_keys % nc).astype(np.int64)
    ip = np.concatenate([[0], np.cumsum(np.bincount(r2, minlength=nc))]).astype(np.int64)
    return ip, c2, cw, cvwts, cmap


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


def _host_weights(csr: CSR) -> np.ndarray:
    """``|vals|`` as float64 on the host; ones for a pattern matrix."""
    if csr.vals is None:
        return np.ones(csr.nnz, np.float64)
    return csr.vals.cpu().abs().to(torch.float64).numpy()


def multilevel_partition(csr: CSR, params: MetisPartitionParams) -> torch.Tensor:
    """Labels of ``csr``'s vertices, int32 on its device."""
    from ...native import available, partition_kway
    from ..reorder._host import host_arrays, to_order

    n = csr.nrows
    k = int(params.num_partitions)
    if k <= 1:
        return torch.zeros((n,), dtype=torch.int32, device=csr.indptr.device)
    indptr, indices = host_arrays(csr)
    if params.ptype == "kway" and available():
        ew = None if csr.vals is None else _host_weights(csr)
        return to_order(partition_kway(n, indptr, indices, ew, k, params.seed, params.ufactor, params.niter), csr)
    indptr, indices, ewts = _symmetrize(indptr, indices, _host_weights(csr), n)
    vwts = np.ones(n, np.float64)
    rng = np.random.default_rng(params.seed)
    total_w = float(vwts.sum())
    cap = (1.0 + params.ufactor / 1000.0) * total_w / k

    def ladder(coarsest):
        graphs = [(indptr, indices, ewts, vwts)]
        cmaps = []
        while len(graphs[-1][0]) - 1 > coarsest:
            ip, ix, ew, vw = graphs[-1]
            nv = len(ip) - 1
            match = _heavy_edge_matching(ip, ix, ew, vw, rng, max_vwt=4.0 * total_w / max(nv, 1))
            nip, nix, new, nvw, cmap = _contract(ip, ix, ew, vw, match)
            if len(nip) - 1 >= nv * 0.95:
                break
            graphs.append((nip, nix, new, nvw))
            cmaps.append(cmap)

        ip, ix, ew, vw = graphs[-1]
        if params.ptype == "rb" and k > 2:
            labels = _recursive_bisection(ip, ix, ew, vw, k, rng, params.ufactor)
        else:
            labels = _region_grow(ip, ix, ew, vw, k, rng, cap)
        labels = _refine(ip, ix, ew, vw, labels, k, cap, rounds=params.niter)
        for level in range(len(cmaps) - 1, -1, -1):
            labels = labels[cmaps[level]]
            ip, ix, ew, vw = graphs[level]
            labels = _refine(ip, ix, ew, vw, labels, k, cap, rounds=max(params.niter // 2, 2))
        return labels

    def cut_of(lab):
        row = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        return float(ewts[lab[row] != lab[indices]].sum())

    # two ladder depths (a shallow one keeps the geometry at small k, a deep
    # one gives the initial partition a small coarsest graph at large k); the
    # least cut is kept, as in graphkit's kway_core
    best_lab, best_cut = None, None
    for coarsest in {max(20 * k, 128), max(4 * k, 48)}:
        lab = ladder(coarsest)
        c = cut_of(lab)
        if best_cut is None or c < best_cut:
            best_lab, best_cut = lab, c
    return to_order(best_lab, csr)


def _recursive_bisection(ip, ix, ew, vw, k, rng, ufactor):
    """k-way by recursive 2-way splits (the METIS_PartGraphRecursive analogue)."""
    n = len(ip) - 1
    labels = np.zeros(n, np.int64)

    def split(vertices, parts_lo, parts_hi):
        if parts_hi - parts_lo <= 1 or len(vertices) == 0:
            labels[vertices] = parts_lo
            return
        sub_id = np.full(n, -1, np.int64)
        sub_id[vertices] = np.arange(len(vertices))
        row = np.repeat(np.arange(n, dtype=np.int64), np.diff(ip))
        emask = (sub_id[row] >= 0) & (sub_id[ix] >= 0)
        sr, sc, sw = sub_id[row[emask]], sub_id[ix[emask]], ew[emask]
        sip = np.concatenate([[0], np.cumsum(np.bincount(sr, minlength=len(vertices)))]).astype(np.int64)
        order = np.argsort(sr, kind="stable")
        six, sew = sc[order], sw[order]
        svw = vw[vertices]
        mid = (parts_hi - parts_lo) // 2
        frac_cap = (1.0 + ufactor / 1000.0) * svw.sum() / 2
        two = _region_grow(sip, six, sew, svw, 2, rng, frac_cap)
        two = _refine(sip, six, sew, svw, two, 2, frac_cap)
        split(vertices[two == 0], parts_lo, parts_lo + mid)
        split(vertices[two == 1], parts_lo + mid, parts_hi)

    split(np.arange(n), 0, k)
    return labels


class MetisPartition(Partitioner):
    """Multilevel k-way partitioner (the METIS API)."""

    def __init__(self, **kw):
        super().__init__("metis_partition")
        self.params = MetisPartitionParams(**kw)
        self.register((CSR,), lambda f, p: multilevel_partition(f[0], p))
