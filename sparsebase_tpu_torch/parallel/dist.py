"""Distributed functions over a ShardedCSR: per-shard work, then a collective.

Counterpart of ``sparsebase_tpu/parallel/dist.py``. Each ``shard_map`` body
of the JAX module is a per-shard function here, called for each shard on
its device, and its collective (``psum``, ``pmax``, ``pmin``) combines the
shards' results (``parallel.collectives``). Replicated inputs (``x``, a
frontier, labels, orders) are copied to each shard's device, shared where
shards share one. Replicated results (levels, labels, orders, scalars)
come back on the mesh's first device; sharded results (``spmv``'s y,
``degrees``) are joined there in row order.

* :func:`spmv` — row-sharded SpMV, K2 per shard on its local CSR
* :func:`degrees` — per-vertex degrees
* :func:`bfs_levels` — level-synchronous frontier BFS; the frontier
  exchange is a ``psum``; one host read per level ("any frontier left?")
* :func:`degree_reorder`, :func:`rcm_reorder` — ranks by a stable K5 sort
* :func:`edge_cut`, :func:`refine_partition`, :func:`label_prop_partition`
  — part sizes and counts as float32 sums of integers (exact, so the
  results do not depend on the number of shards)
* :func:`structure_features` — bandwidth, profile (an exact int64 sum),
  nnz, min/max/avg degree
* :func:`reorder_heatmap` — b×b block density under two orders

A shard's work covers its true entries only (its count is read back once
and kept by the container): the JAX bodies mask the padded slots, which
here would all add into one cell. The JAX ``while_loop`` of the BFS is a
Python loop; the ``fori_loop`` s of refinement and label propagation have a
fixed trip count and read nothing back.

Every function runs on a mesh that spans processes: each process works on
its own shards (``None`` in a remote shard's slot), its collectives name the
shards' owners, and it holds the replicated results on its first shard's
device, equal bit for bit to the single-process mesh's. A vector joined
from the shards (y, a round's labels, the gains) is gathered from the other
processes, never ``torch.cat`` ed from this process's pieces alone.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.kernels.csr_spmv import csr_spmv
from ..ops.kernels.radix import bits_below, radix_argsort, radix_rank
from .collectives import host_fetch, join, pmax, pmin, psum
from .mesh import Mesh, replicated
from .sharded import ShardedCSR

_INT32_MAX = 2**31 - 1


def _local_row_of(indptr_local, width: int) -> torch.Tensor:
    """Row id (local) of each of the first ``width`` entry slots of a shard:
    row-start markers scattered and summed. A row starting at ``width`` (an
    empty row after the last entry) has no slot: its marker is dropped."""
    marks = torch.zeros((width + 1,), dtype=torch.int64, device=indptr_local.device)
    marks.index_add_(0, torch.clamp(indptr_local[:-1], max=width), torch.ones_like(indptr_local[:-1]))
    return torch.cumsum(marks[:width], 0) - 1


def _shards(sh: ShardedCSR, mesh: Mesh):
    """Check that ``mesh`` holds the shards along the container's axis;
    returns ``(n, d, rows, width)``."""
    if mesh.axis_devices(sh.axis) != sh.devices or mesh.axis_owners(sh.axis) != sh.owners:
        raise ValueError(f"the shards lie on {[str(d) for d in sh.devices]}, not on the mesh {mesh!r} along "
                         f"{sh.axis!r}")
    return sh.shape[0], sh.n_shards, sh.rows_per_shard, sh.width


def _entries(sh: ShardedCSR, k: int, n: int):
    """Shard ``k``'s true entries: ``(global row, valid, column)`` (valid: a
    row below n, as the JAX bodies mask it)."""
    cnt = sh.nnz_counts[k]
    grow = k * sh.rows_per_shard + _local_row_of(sh.indptr[k], cnt)
    return grow, grow < n, sh.indices[k][:cnt].long()


def _local_entries(sh: ShardedCSR, n: int) -> list:
    """:func:`_entries` of this process's shards, ``None`` in a remote
    shard's slot."""
    return [_entries(sh, k, n) if k in sh.local else None for k in range(sh.n_shards)]


def _max0(t: torch.Tensor) -> torch.Tensor:
    """``t.max()``, 0 for a shard with no entries (the JAX bodies take the
    max over masked slots)."""
    return t.max() if t.numel() else torch.zeros((), dtype=t.dtype, device=t.device)


def spmv(sh: ShardedCSR, x, mesh: Mesh):
    """y = A @ x with A row-sharded and x replicated: K2 on each shard's
    local CSR; y joined in row order on the mesh's first device."""
    n, d, rows, width = _shards(sh, mesh)
    xs = replicated(mesh).put(x)
    ys = [None] * d
    for k in sh.local:
        ys[k] = csr_spmv(sh.shard_csr(k), xs[k])
    return join(ys, sh.owners, mesh.first_device)[:n]


def degrees(sh: ShardedCSR, mesh: Mesh):
    """Per-vertex degree (int64), joined in row order."""
    n = _shards(sh, mesh)[0]
    return join([None if ip is None else ip[1:] - ip[:-1] for ip in sh.indptr], sh.owners, mesh.first_device)[:n]


def bfs_levels(sh: ShardedCSR, root: int, mesh: Mesh, max_iters: Optional[int] = None,
               stats: Optional[dict] = None):
    """Level-synchronous BFS from ``root``; returns the (n,) int32 levels
    (-1 = unreached). The frontier exchange is a ``psum`` of per-shard
    reach counts. Each level reads "any frontier left?" back once;
    ``stats``, a dict, receives ``levels`` and ``host_reads``."""
    n, d, rows, width = _shards(sh, mesh)
    first, local = mesh.first_device, sh.local
    iters = max_iters or n
    # a column past n (a matrix with more columns than rows) marks the
    # discard slot n: the JAX scatter drops it
    slots = {}
    for k in local:
        grow, valid, idx = _entries(sh, k, n)
        slots[k] = (grow, valid, torch.clamp(idx, max=n))
    frontier = torch.arange(n, device=first) == root
    levels = torch.where(frontier, 0, -1).to(torch.int32)
    it = reads = 0
    while it < iters:
        reads += 1
        if not bool(frontier.any()):
            break
        reached = [None] * d
        fronts = replicated(mesh).put(frontier)
        for k in local:
            f, (grow, valid, idx) = fronts[k], slots[k]
            active = valid & f[torch.clamp(grow, 0, n - 1)]
            reached[k] = torch.zeros((n + 1,), dtype=torch.int32, device=f.device).index_add_(
                0, idx, active.to(torch.int32))
        nxt = (psum(reached, sh.owners)[local[0]][:n] > 0) & (levels < 0)
        levels = torch.where(nxt, it + 1, levels)
        frontier = nxt
        it += 1
    if stats is not None:
        stats.update(levels=it, host_reads=reads)
    return levels


def degree_reorder(sh: ShardedCSR, mesh: Mesh, ascending: bool = True):
    """Distributed degree reorder: the stable rank of the degrees (K5), an
    int32 inverse permutation ``order[old] = new``."""
    deg = degrees(sh, mesh)
    width = sh.width  # no degree exceeds it
    keys = deg if ascending else width - deg
    return radix_rank(keys, key_bits=bits_below(width + 1))


def rcm_reorder(sh: ShardedCSR, mesh: Mesh, root: int = 0, max_iters: Optional[int] = None):
    """Distributed level-synchronous RCM: BFS levels from ``root`` through
    the sharded frontier exchange, then the stable rank (K5) of the key
    (level, degree, id), reversed over the reached vertices; unreached
    vertices (other components) follow in id order. Returns an int32
    inverse permutation."""
    levels = bfs_levels(sh, root, mesh, max_iters=max_iters)
    return _rcm_rank(levels, degrees(sh, mesh), sh.shape[0])


def _rcm_rank(levels, deg, n: int) -> torch.Tensor:
    """The int32 inverse permutation of the stable rank (K5) of (level,
    degree, id), reversed over the reached vertices; unreached vertices
    (level -1) rank as level n, after the BFS tree. The level and degree
    bits stated to K5 come from their largest values, read back once: an
    approximate level (:func:`.halo.bfs_levels_multilevel`) can exceed n."""
    if n == 0:
        return torch.zeros((0,), dtype=torch.int32, device=levels.device)
    unreached = levels < 0
    lev = torch.where(unreached, n, levels).to(torch.int64)
    deg = deg.to(torch.int64)
    # replicated values: each process reads its own copy
    top_lev, top_deg = host_fetch([lev.max(), deg.max()])
    key = (lev << 32) | deg
    pos = radix_rank(key, key_bits=[(0, bits_below(top_deg + 1)), (32, 32 + bits_below(top_lev + 1))]).to(torch.int64)
    reached_count = (~unreached).sum()
    return torch.where(pos < reached_count, reached_count - 1 - pos, pos).to(torch.int32)


def _cut_parts(labels, n: int, slots):
    """Per-shard counts of entries whose row and column labels differ
    (``labels``: one copy per shard; ``None`` for a remote shard)."""
    parts = []
    for lab, slot in zip(labels, slots):
        if slot is None:
            parts.append(None)
            continue
        grow, valid, idx = slot
        crossing = valid & (lab[torch.clamp(grow, 0, n - 1)] != lab[torch.clamp(idx, 0, n - 1)])
        parts.append(crossing.sum())
    return parts


def _on_first(t, mesh: Mesh) -> torch.Tensor:
    """A replicated input as a tensor on the mesh's first device."""
    return torch.as_tensor(t).to(mesh.first_device)


def edge_cut(sh: ShardedCSR, labels, mesh: Mesh):
    """Total directed edge cut of a labelling: a ``psum`` of per-shard
    counts of entries whose row and column labels differ (int64)."""
    n, d, rows, width = _shards(sh, mesh)
    labels = replicated(mesh).put(_on_first(labels, mesh))
    return psum(_cut_parts(labels, n, _local_entries(sh, n)), sh.owners)[sh.local[0]]


def _label_counts(sh: ShardedCSR, k: int, lab, n: int, parts: int):
    """Shard ``k``'s (rows, parts) float32 counts of its rows' neighbours'
    labels, and its rows' global ids and labels. A column past n reads the
    label of n - 1, as the JAX gather clamps it."""
    rows, cnt = sh.rows_per_shard, sh.nnz_counts[k]
    dev = sh.devices[k]
    idx = torch.clamp(sh.indices[k][:cnt].long(), 0, n - 1)
    lrow = _local_row_of(sh.indptr[k], cnt)
    counts = torch.zeros((rows * parts,), dtype=torch.float32, device=dev)
    counts.index_add_(0, lrow * parts + lab[idx].long(), torch.ones((cnt,), dtype=torch.float32, device=dev))
    grows = k * rows + torch.arange(rows, device=dev)
    cur = lab[torch.clamp(grows, 0, n - 1)].long()
    return counts.view(rows, parts), grows, cur


def _shard_label_counts(sh: ShardedCSR, lab, n: int, parts: int) -> list:
    """:func:`_label_counts` of this process's shards under the labels
    ``lab`` (replicated), ``None`` in a remote shard's slot."""
    return [None if labs is None else _label_counts(sh, j, labs, n, parts)
            for j, labs in enumerate(replicated(sh.mesh).put(lab))]


def _part_sizes(local, n: int, parts: int, owners):
    """Each part's row count, float32, ``psum``'d over the shards' ``local``
    counts (rows past n left out)."""
    sizes = [None] * len(local)
    for j, loc in enumerate(local):
        if loc is not None:
            _, grows, cur = loc
            sizes[j] = torch.zeros((parts,), dtype=torch.float32, device=cur.device).index_add_(
                0, cur, (grows < n).to(torch.float32))
    return psum(sizes, owners)


def _float_order_key(f: torch.Tensor) -> torch.Tensor:
    """An int64 key in [0, 2**32) that orders float32 values as ``<`` does
    (no NaN; -0.0 is taken as 0.0)."""
    bits = (f + 0.0).view(torch.int32)
    return (bits ^ ((bits >> 31) & 0x7FFFFFFF)).to(torch.int64) + 2**31


def refine_partition(sh: ShardedCSR, labels, k: int, mesh: Mesh, rounds: int = 4, balance: float = 1.1):
    """Distributed boundary refinement: each round, every shard computes its
    rows' label affinities locally, part sizes are ``psum``'d, and
    positive-gain moves into parts with headroom are admitted in the order
    (target part, gain descending, id) up to each part's headroom. The
    best labelling seen (by edge cut) is returned, as int32."""
    n, d, rows, width = _shards(sh, mesh)
    first, owners, l0 = mesh.first_device, sh.owners, sh.local[0]
    cap = torch.full((), balance * n / k, dtype=torch.float32, device=first)
    slots = _local_entries(sh, n)
    lab = _on_first(labels, mesh).to(torch.int32)
    best_lab, best_cut = lab, psum(_cut_parts(replicated(mesh).put(lab), n, slots), owners)[l0]
    inf = torch.full((), float("inf"), device=first)
    pos = torch.arange(n, dtype=torch.int64, device=first)
    key_bits = [(0, 32), (32, 32 + bits_below(k))]
    for _ in range(rounds):
        local = _shard_label_counts(sh, lab, n, k)
        sizes = _part_sizes(local, n, k, owners)
        gains, bests = [None] * d, [None] * d
        for j in sh.local:
            counts, grows, cur = local[j]
            full = sizes[j] >= cap.to(sizes[j].device)
            ar = torch.arange(rows, device=counts.device)
            cur_aff = counts[ar, cur]
            masked = torch.where(full[None, :], -inf.to(counts.device), counts)
            masked[ar, cur] = -inf.to(counts.device)
            bests[j] = torch.argmax(masked, dim=1).to(torch.int32)
            gains[j] = torch.where(grows < n, masked.max(dim=1).values - cur_aff, -inf.to(counts.device))
        # every process holds every row's gain and best part: they rank the
        # same moves in the same K5 sort
        gain, best = join(gains, owners, first)[:n], join(bests, owners, first)[:n]
        headroom = torch.clamp(torch.floor(cap - sizes[l0]), min=0.0)
        # lexsort((id, -gain, best)): one stable sort of (best, -gain)
        order = radix_argsort((best.to(torch.int64) << 32) | _float_order_key(-gain), key_bits=key_bits).long()
        best_s = best[order].long()
        start = torch.full((k,), n, dtype=torch.int64, device=first).scatter_reduce_(0, best_s, pos, "amin")
        rank = pos - start[best_s]
        admit_s = (gain[order] > 0) & (rank < headroom[best_s])
        admit = torch.zeros((n,), dtype=torch.bool, device=first)
        admit[order] = admit_s
        new_lab = torch.where(admit, best, lab)
        # simultaneous moves can conflict and raise the cut; keep the best
        # labelling seen so the result is monotone against the input
        new_cut = psum(_cut_parts(replicated(mesh).put(new_lab), n, slots), owners)[l0]
        better = new_cut < best_cut
        best_lab = torch.where(better, new_lab, best_lab)
        best_cut = torch.where(better, new_cut, best_cut)
        lab = new_lab
    return best_lab


def structure_features(sh: ShardedCSR, mesh: Mesh):
    """Distributed bandwidth / profile / nnz / min/max/avg degree in one
    pass: per-shard reductions combined with ``psum``/``pmax``/``pmin``.
    Returns a dict of 0-d tensors on the mesh's first device. The profile
    is an exact int64 sum (the JAX package sums it in float32)."""
    n, d, rows, width = _shards(sh, mesh)
    first, owners, l0 = mesh.first_device, sh.owners, sh.local[0]
    bw, prof, nnz, min_deg, max_deg = ([None] * d for _ in range(5))
    for k in sh.local:
        ip = sh.indptr[k]
        dev = ip.device
        grow, valid, idx = _entries(sh, k, n)
        lrow = grow - k * rows
        bw[k] = _max0(torch.where(valid, (grow - idx).abs() + 1, 0))
        # profile: sum over rows of (row - min col) for rows with entries
        mincol = torch.full((rows,), _INT32_MAX, dtype=torch.int64, device=dev)
        mincol.scatter_reduce_(0, lrow, torch.where(valid, idx, _INT32_MAX), "amin")
        grows = k * rows + torch.arange(rows, device=dev)
        deg = ip[1:] - ip[:-1]
        has = (deg > 0) & (grows < n)
        prof[k] = torch.where(has, torch.clamp(grows - mincol, min=0), 0).sum()
        nnz[k] = sh.nnz_local[k]
        # pad rows (global id >= n) are left out of the min and max
        min_deg[k] = torch.where(grows < n, deg, _INT32_MAX).min()
        max_deg[k] = torch.where(grows < n, deg, 0).max()
    nnz = psum(nnz, owners)[l0].to(first)
    return {
        "bandwidth": pmax(bw, owners)[l0].to(first),
        "profile": psum(prof, owners)[l0].to(first),
        "nnz": nnz,
        "min_degree": pmin(min_deg, owners)[l0].to(first),
        "max_degree": pmax(max_deg, owners)[l0].to(first),
        "avg_degree": nnz.to(torch.float32) / torch.full((), max(n, 1), dtype=torch.float32, device=first),
    }


def label_prop_partition(sh: ShardedCSR, k: int, mesh: Mesh, num_iters: int = 10, balance: float = 1.1):
    """Distributed size-constrained label propagation (PULP-style): labels
    replicated, per-shard neighbour counts, ``psum``'d part sizes, a
    multiplicative balance weight and strict-improvement moves on
    alternating halves; returns the (n,) int32 labels. Every shard's float32
    arithmetic is the JAX body's as XLA compiles it, in its order: the
    weight's ``sizes / cap`` is a product with cap's float32 reciprocal
    (XLA's rewrite of a division by a constant), so near-ties fall as they
    do there."""
    n, d, rows, width = _shards(sh, mesh)
    first, owners = mesh.first_device, sh.owners
    labels = ((torch.arange(n, dtype=torch.int64, device=first) * k) // max(n, 1)).to(torch.int32)
    cap = torch.full((), balance * n / k, dtype=torch.float32, device=first)
    inv_cap = torch.full((), 1.0, dtype=torch.float32, device=first) / cap
    margin = torch.full((), 1.000001, dtype=torch.float32, device=first)
    eps = torch.full((), 1e-6, dtype=torch.float32, device=first)
    for it in range(num_iters):
        local = _shard_label_counts(sh, labels, n, k)
        sizes = _part_sizes(local, n, k, owners)
        new = [None] * d
        for j in sh.local:
            counts, grows, cur = local[j]
            dev = counts.device
            weight = torch.clamp(1.0 - sizes[j] * inv_cap.to(dev), min=0.0)
            scores = counts * weight[None, :]
            cur_score = scores[torch.arange(rows, device=dev), cur]
            best = torch.argmax(scores, dim=1)
            best_score = scores.max(dim=1).values
            ip = sh.indptr[j]
            active = ((grows + it) % 2 == 0) & ((ip[1:] - ip[:-1]) > 0)
            # never empty a part
            keeps_alive = sizes[j][torch.clamp(cur, 0, k - 1)] > 1.5
            move = active & keeps_alive & (best_score > cur_score * margin.to(dev) + eps.to(dev))
            new[j] = torch.where(move, best, cur).to(torch.int32)
        # the replicated labels: every shard's rows, gathered across processes
        labels = join(new, owners, first)[:n]
    return labels


def reorder_heatmap(sh: ShardedCSR, order_r, order_c, mesh: Mesh, num_parts: int = 8):
    """Distributed b×b block-density heatmap of a reordered sharded matrix:
    per-shard histograms combined with a (b²,) ``psum``. Returns the (b, b)
    float32 grid (counts / nnz)."""
    n, d, rows, width = _shards(sh, mesh)
    m = sh.shape[1]
    b = int(num_parts)
    bsize = max(n // b, 1)
    rows_order = replicated(mesh).put(_on_first(order_r, mesh))
    cols_order = replicated(mesh).put(_on_first(order_c, mesh))
    hists = [None] * d
    for k in sh.local:
        dev = sh.devices[k]
        grow, valid, idx = _entries(sh, k, n)
        u = rows_order[k][torch.clamp(grow, 0, n - 1)].long()
        v = cols_order[k][torch.clamp(idx, 0, m - 1)].long()
        bu = torch.clamp(u // bsize, max=b - 1)
        bv = torch.clamp(v // bsize, max=b - 1)
        flat = torch.where(valid, bu * b + bv, b * b)  # b * b: the discard cell
        hists[k] = torch.zeros((b * b + 1,), dtype=torch.int64, device=dev).index_add_(
            0, flat, torch.ones_like(flat))[: b * b]
    counts = psum(hists, sh.owners)[sh.local[0]].to(mesh.first_device)
    nnz = torch.full((), max(sh.nnz, 1), dtype=torch.float32, device=counts.device)
    return counts.reshape(b, b).to(torch.float32) / nnz
