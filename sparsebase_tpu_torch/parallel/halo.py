"""Halo-exchange distributed functions: boundary-proportional communication.

Counterpart of ``sparsebase_tpu/parallel/halo.py`` up to the refinement
(matching, coarsening, the multilevel functions and SlashBurn are not
ported yet). The functions of :mod:`.dist` exchange dense ``(n,)`` vectors
with ``psum``; here each shard ships only the values its neighbours read,
through the halo lists of :class:`~.sharded.ShardedCSR` (``halo_send``,
``halo_counts``, ``halo_map``) and one ``all_to_all`` a step: one exchange
moves ``sum(halo_counts) * itemsize`` bytes (:func:`step_comm_bytes`),
proportional to the partition boundary, not to n.

Each JAX ``shard_map`` body is a per-shard function here, called for each
shard on its device and followed by a collective of :mod:`.collectives`;
each JAX ``*_runner`` is a plain function named without the suffix
(nothing is compiled or cached). Vectors stay sharded: a tuple of (R,)
tensors, shard k's on its device. A shard's work covers its true entries
only (``nnz_counts``), never the padded slots, and every padded shape and
replicated result equals the JAX function's.

* :func:`spmv` — K2 per shard on its local CSR whose columns are the
  ``halo_map`` slots, against the extended vector
* :func:`bfs_levels` — push BFS; the marks on remote vertices ride the
  reverse ``all_to_all`` back to their owners
* :func:`label_prop_partition` — sharded labels, one exchange and a (k,)
  ``psum`` a round
* :func:`connected_components` — min-label hooking, grandparent hooking and
  pointer jumping
* :func:`rcm_reorder` — pseudo-peripheral root search and a distributed
  counting rank (K5 and K3 per shard, an ``all_gather`` of the histograms)
* :func:`edge_cut`, :func:`refine_partition` — sharded-label cut and
  boundary refinement with exact top-headroom admission

Gathers clamp and scatters drop an index out of range, as JAX's do: on a
matrix with more columns than the shards have rows, a column past the last
shard's rows maps past its owner's rows.

The JAX ``while_loop`` s are host loops that read one flag back a step (a
BFS level, a components round, a pointer jump; ``stats=`` counts them); the
``fori_loop`` s of label propagation, the rank refinement and the partition
refinement read nothing back.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..formats.csr import CSR
from ..ops.kernels.csr_spmv import csr_spmv
from ..ops.kernels.indptr import indptr_from_sorted_rows
from ..ops.kernels.radix import bits_below, radix_argsort
from .collectives import all_gather, all_to_all, pmax, pmin, psum
from .dist import _local_row_of, _shards
from .mesh import Mesh
from .sharded import ShardedCSR

_BIG = 2**31 - 1


def _require_halo(sh: ShardedCSR):
    if not sh.has_halo:
        raise ValueError("this function needs halo metadata — build the ShardedCSR with halo=True or call .with_halo()")


def _exchange(x_local: Sequence[torch.Tensor], halo_send_l: Sequence[torch.Tensor], axis: str = "x"):
    """One halo exchange: each shard's extended local vector ``[R local
    values | D*S received halo values]``, whose slots match ``halo_map``
    (the slot of (owner o, j) is ``R + o*S + j``).

    ``x_local``: the shards' (R,) vectors and ``halo_send_l`` their (D, S)
    lists of rows in [0, R) (:func:`_sends`), in the order of the mesh
    axis ``axis``. One ``all_to_all`` of (D, S) values."""
    sends = [torch.index_select(x, 0, hs.reshape(-1)).view(hs.shape) for x, hs in zip(x_local, halo_send_l)]
    return tuple(torch.cat([x, r.reshape(-1)]) for x, r in zip(x_local, all_to_all(sends)))


def _wide(sh: ShardedCSR) -> bool:
    """Whether a column can lie past the shards' rows (more columns than
    d·R): its owner, the last shard, lists it past its rows."""
    return sh.shape[1] > sh.n_shards * sh.rows_per_shard


def _sends(sh: ShardedCSR) -> tuple:
    """The shards' ``halo_send`` lists for :func:`_exchange`: a listed row
    past R reads row R - 1, as the JAX gather clamps it."""
    rows = sh.rows_per_shard
    return tuple(hs.clamp(max=rows - 1) for hs in sh.halo_send) if _wide(sh) else sh.halo_send


def step_comm_bytes(sh: ShardedCSR, itemsize: int = 4) -> int:
    """True payload bytes one halo exchange moves: proportional to the
    partition boundary, not n."""
    _require_halo(sh)
    return itemsize * sh.halo_bytes_per_exchange // 4


def _pad_vec(x, d: int, rows: int, n: int, fill=0) -> torch.Tensor:
    """``x`` (n,) padded with ``fill`` to ``(d, rows)``."""
    x = torch.as_tensor(x)
    if x.shape != (n,):
        raise ValueError(f"a vector of shape {tuple(x.shape)} for a matrix of {n} rows")
    pad = torch.full((d * rows - n,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad]).view(d, rows)


def _statics(sh: ShardedCSR):
    return sh.axis, sh.shape[0], sh.n_shards, sh.rows_per_shard, sh.width, sh.halo_width


def _put(sh: ShardedCSR, x, fill=0, dtype=None) -> tuple:
    """A replicated (n,) vector as the shards' (R,) pieces, padded with
    ``fill``, each on its shard's device."""
    _, n, d, rows, _, _ = _statics(sh)
    x = torch.as_tensor(x)
    if dtype is not None:
        x = x.to(dtype)
    return tuple(p.to(dev) for p, dev in zip(_pad_vec(x, d, rows, n, fill).unbind(0), sh.devices))


def _join(parts, mesh: Mesh, n: int) -> torch.Tensor:
    """The shards' (R,) pieces joined in row order on the mesh's first
    device, cut to n."""
    return torch.cat([p.to(mesh.first_device) for p in parts])[:n]


def _gids(sh: ShardedCSR) -> tuple:
    """Each shard's global row ids (int64)."""
    rows = sh.rows_per_shard
    return tuple(k * rows + torch.arange(rows, device=dev) for k, dev in enumerate(sh.devices))


def _slots(sh: ShardedCSR, drop: bool = False) -> list:
    """Each shard's true entries: ``(local row, slot in the extended
    vector)``, int64. A slot past the extended vector (a column past the
    last shard's rows) becomes its last slot, as a gather clamps it, or
    with ``drop`` one past it, a discard slot for a scatter."""
    _, n, d, rows, _, s = _statics(sh)
    ext_len = rows + d * s
    wide = _wide(sh)
    out = []
    for k in range(d):
        cnt = sh.nnz_counts[k]
        slot = sh.halo_map[k][:cnt].long()
        if wide:
            slot = slot.clamp(max=ext_len if drop else ext_len - 1)
        out.append((_local_row_of(sh.indptr[k], cnt), slot))
    return out


def _f32(v, device) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=device)


def _weights(sh: ShardedCSR, vertex_weights, mesh: Mesh):
    """``(the shards' vertex weights, their total)``: unit weights and n, or
    the float32 weights (pads 0) and their float32 sum, read back as the
    JAX functions read it. Integer weights whose total is below 2**24 sum
    exactly."""
    n = sh.shape[0]
    if vertex_weights is None:
        return _put(sh, torch.ones((n,), dtype=torch.float32, device=mesh.first_device)), float(n)
    vw = torch.as_tensor(vertex_weights).to(device=mesh.first_device, dtype=torch.float32)
    return _put(sh, vw), float(vw.sum())


def _sizes(labels, weights, gids, n: int, k: int) -> tuple:
    """Each part's weight (float32), ``psum``'d over the shards' rows below n."""
    return psum([torch.zeros((k,), dtype=torch.float32, device=lab.device).index_add_(
        0, lab.long(), torch.where(g < n, w, 0.0)) for lab, w, g in zip(labels, weights, gids)])


# -- SpMV -----------------------------------------------------------------------
def spmv(sh: ShardedCSR, x, mesh: Mesh):
    """y = A @ x with A row-sharded and x sharded (not replicated): the
    remote entries of x arrive through the halo ``all_to_all``; then K2 on
    each shard's local CSR whose columns are its ``halo_map`` slots. y is
    joined in row order on the mesh's first device."""
    _require_halo(sh)
    n, d, rows, _ = _shards(sh, mesh)
    ext_len = rows + d * sh.halo_width
    ext = _exchange(_put(sh, x), _sends(sh), sh.axis)
    wide = _wide(sh)
    ys = []
    for k in range(d):
        cnt = sh.nnz_counts[k]
        cols = sh.halo_map[k][:cnt]
        if wide:
            cols = cols.clamp(max=ext_len - 1)
        vals = None if sh.vals is None else sh.vals[k][:cnt]
        ys.append(csr_spmv(CSR(sh.indptr[k], cols, vals, (rows, ext_len)), ext[k]))
    return _join(ys, mesh, n)


# -- BFS ------------------------------------------------------------------------
def _bfs_sharded(sh: ShardedCSR, root, mesh: Mesh, max_iters: Optional[int] = None,
                 stats: Optional[dict] = None):
    """Push BFS from ``root`` (an int or a 0-d tensor, read on the device):
    ``(the shards' (R,) int32 levels, levels run)``. Each level reads "any
    frontier left?" back once; ``stats`` adds up ``levels`` and
    ``host_reads``."""
    n, d, rows, _ = _shards(sh, mesh)
    ext_len = rows + d * sh.halo_width
    iters = max_iters or n
    slots = _slots(sh, drop=True)
    sends = [hs.long() for hs in sh.halo_send]
    frontier = [g == (root.to(g.device) if isinstance(root, torch.Tensor) else root) for g in _gids(sh)]
    levels = [torch.where(f, 0, -1).to(torch.int32) for f in frontier]
    it = reads = 0
    while it < iters:
        reads += 1
        if not bool(torch.stack([f.any().to(mesh.first_device) for f in frontier]).any()):
            break
        # active rows mark their neighbours' slots (a discard slot at the end)
        ext = []
        for f, (lrow, slot) in zip(frontier, slots):
            e = torch.zeros((ext_len + 1,), dtype=torch.bool, device=f.device)
            ext.append(e.index_fill_(0, torch.where(f[lrow], slot, ext_len), True))
        # the marks on owner o's vertices go back to o, which marks its rows
        recv = all_to_all([e[rows:ext_len].view(d, sh.halo_width) for e in ext])
        nxt = []
        for e, r, hs, lev in zip(ext, recv, sends, levels):
            e.index_fill_(0, torch.where(r & (hs < rows), hs, ext_len).reshape(-1), True)
            nxt.append(e[:rows] & (lev < 0))
        levels = [torch.where(x, it + 1, lev) for x, lev in zip(nxt, levels)]
        frontier = nxt
        it += 1
    if stats is not None:
        stats["levels"] = stats.get("levels", 0) + it
        stats["host_reads"] = stats.get("host_reads", 0) + reads
    return tuple(levels), it


def bfs_levels(sh: ShardedCSR, root, mesh: Mesh, max_iters: Optional[int] = None, stats: Optional[dict] = None):
    """Push-style level-synchronous BFS; frontier and levels stay sharded,
    each level exchanges only halo marks. Returns the (n,) int32 levels (-1
    = unreached); ``stats``, a dict, receives ``levels`` and
    ``host_reads``."""
    _require_halo(sh)
    levels, _ = _bfs_sharded(sh, root, mesh, max_iters, stats)
    return _join(levels, mesh, sh.shape[0])


# -- label propagation ----------------------------------------------------------
def label_prop_partition(sh: ShardedCSR, k: int, mesh: Mesh, num_iters: int = 10, balance: float = 1.1,
                         vertex_weights=None):
    """Size-constrained label propagation with sharded labels: each round
    exchanges the halo labels and ``psum`` s the (k,) part sizes;
    ``vertex_weights`` (n,) measures the parts by weight. The float32
    arithmetic is the JAX body's as XLA compiles it: ``sizes / cap`` is a
    product with cap's float32 reciprocal. Returns the (n,) int32 labels."""
    _require_halo(sh)
    n, d, rows, _ = _shards(sh, mesh)
    first = mesh.first_device
    weights, total = _weights(sh, vertex_weights, mesh)
    cap = _f32(balance * total / k, first)
    inv_cap, margin, eps = _f32(1.0, first) / cap, _f32(1.000001, first), _f32(1e-6, first)
    gids, slots, sends = _gids(sh), _slots(sh), _sends(sh)
    degs = _degrees(sh)
    labels = [torch.clamp(g * k // max(n, 1), max=k - 1).to(torch.int32) for g in gids]
    for it in range(num_iters):
        ext = _exchange(labels, sends, sh.axis)
        sizes = _sizes(labels, weights, gids, n, k)
        new = []
        for j, dev in enumerate(sh.devices):
            lrow, slot = slots[j]
            counts = torch.zeros((rows * k,), dtype=torch.float32, device=dev).index_add_(
                0, lrow * k + ext[j][slot].long(), torch.ones_like(lrow, dtype=torch.float32)).view(rows, k)
            scores = counts * torch.clamp(1.0 - sizes[j] * inv_cap.to(dev), min=0.0)[None, :]
            cur = labels[j].long()
            cur_score = scores.gather(1, cur[:, None])[:, 0]
            best = torch.argmax(scores, dim=1)
            active = ((gids[j] + it) % 2 == 0) & (degs[j] > 0)
            # a part must never empty: an emptied part stays empty
            keeps_alive = sizes[j][cur.clamp(0, k - 1)] - weights[j] > eps.to(dev)
            move = active & keeps_alive & (scores.max(dim=1).values > cur_score * margin.to(dev) + eps.to(dev))
            new.append(torch.where(move, best, cur).to(torch.int32))
        labels = new
    return _join(labels, mesh, n)


# -- connected components -------------------------------------------------------
def _compress(lab: torch.Tensor, top: int):
    """Pointer jumping to the fixpoint (``lab[lab]`` until nothing moves):
    ``(labels, jumps)``, one host read a jump."""
    jumps = 0
    while True:
        jumps += 1
        hop = torch.where(lab == _BIG, _BIG, lab[lab.clamp(max=top).long()])
        moved = bool((hop != lab).any())
        lab = hop
        if not moved:
            return lab, jumps


def connected_components(sh: ShardedCSR, mesh: Mesh, alive=None, max_iters: Optional[int] = None,
                         stats: Optional[dict] = None):
    """Component labels: ``labels[v]`` is the least vertex id of v's
    component (a symmetric adjacency is assumed). A round hooks each vertex
    to its neighbours' least label through one halo exchange, pushes that
    label to its label vertex (grandparent hooking, a scatter-min) and
    compresses by pointer jumping on the mesh's first device. ``alive``, an
    (n,) bool mask, restricts to the induced subgraph; masked-out vertices
    get -1. ``stats``, a dict, receives ``rounds``, ``jumps`` and
    ``host_reads`` (one a round and one a jump)."""
    _require_halo(sh)
    n, d, rows, _ = _shards(sh, mesh)
    first = mesh.first_device
    iters = int(max_iters) if max_iters is not None else n
    if alive is None:
        alive = torch.ones((n,), dtype=torch.bool, device=first)
    alive_flat = _pad_vec(torch.as_tensor(alive, dtype=torch.bool).to(first), d, rows, n, fill=False).view(-1)
    alive_l = tuple(a.to(dev) for a, dev in zip(alive_flat.view(d, rows), sh.devices))
    slots, sends = _slots(sh), _sends(sh)
    top = d * rows - 1
    labels = torch.where(alive_flat, torch.arange(d * rows, dtype=torch.int32, device=first), _BIG)
    changed, rounds, jumps = True, 0, 0
    while changed and rounds < iters:
        masked = [torch.where(a, lab.to(dev), _BIG) for a, lab, dev in zip(alive_l, labels.view(d, rows), sh.devices)]
        ext = _exchange(masked, sends, sh.axis)
        new = []
        for j, (lrow, slot) in enumerate(slots):
            nbr_min = torch.full((rows,), _BIG, dtype=torch.int32, device=masked[j].device).scatter_reduce_(
                0, lrow, ext[j][slot], "amin")
            new.append(torch.where(alive_l[j], torch.minimum(masked[j], nbr_min), _BIG).to(first))
        nf = torch.cat(new)
        contrib = torch.where(labels == _BIG, _BIG, nf)
        upd = labels.clone().scatter_reduce_(0, labels.clamp(max=top).long(), contrib, "amin")
        new_labels, j = _compress(torch.minimum(nf, upd), top)
        jumps += j
        changed = bool((new_labels != labels).any())
        labels = new_labels
        rounds += 1
    if stats is not None:
        stats.update(rounds=rounds, jumps=jumps, host_reads=rounds + jumps)
    labels = labels[:n]
    return torch.where(labels == _BIG, -1, labels)


# -- RCM ------------------------------------------------------------------------
def _counting_rank(sh: ShardedCSR, bucket, valid, nb: int):
    """Distributed counting rank: the global stable position of every row
    under its bucket key in [0, nb), with the global (nb,) histogram of the
    valid rows on the first shard's device. Per shard a K5 stable sort of
    the keys (``bits_below(nb)`` bits stated) and K3 over the sorted keys
    give each row's place in its bucket and the valid rows' histogram; one
    ``all_gather`` of the (D, nb) histograms gives the global offsets and
    the earlier shards' counts. Invalid rows rank as INT32_MAX."""
    local = []
    for b, v in zip(bucket, valid):
        perm, b_s = radix_argsort(b, key_bits=bits_below(nb), return_keys=True)
        perm = perm.long()
        starts = indptr_from_sorted_rows(b_s, nb)
        seen = torch.cumsum(torch.cat([v.new_zeros((1,)), v[perm]]), 0)
        hist = (seen[starts[1:]] - seen[starts[:-1]]).to(torch.int32)
        local_rank = torch.empty_like(perm)
        local_rank[perm] = torch.arange(perm.shape[0], device=perm.device) - starts[b_s.long()]
        local.append((hist, local_rank))
    gathered = all_gather([hist for hist, _ in local])
    ranks = []
    for k, (b, v, g, (_, local_rank)) in enumerate(zip(bucket, valid, gathered, local)):
        ghist = g.sum(0)
        goffset = torch.cumsum(ghist, 0) - ghist
        b = b.long()
        pos = goffset[b] + g[:k].sum(0)[b] + local_rank
        ranks.append(torch.where(v, pos, _BIG).to(torch.int32))
    return tuple(ranks), gathered[0].sum(0)


def _parent_bucket(sh: ShardedCSR, sends, slots, parents, levels, rank, level_start, pb_count: int):
    """Per row the least rank among its BFS parents (one exchange of the
    ranks and a scatter-min), rebased to the parent level's start in rank
    space and clipped to [0, pb_count). ``parents``: per shard, which
    entries join a row to a vertex one level up (the levels do not change,
    so their exchange is made once by the caller)."""
    rows = sh.rows_per_shard
    ext_rank = _exchange(rank, sends, sh.axis)
    out = []
    for (lrow, slot), par, lev, er in zip(slots, parents, levels, ext_rank):
        cand = torch.where(par, er[slot], _BIG)
        pmin = torch.full((rows,), _BIG, dtype=torch.int32, device=lev.device).scatter_reduce_(0, lrow, cand, "amin")
        start = level_start.to(lev.device)
        parent_lev = torch.clamp(lev.long() - 1, 0, start.shape[0] - 1)
        out.append(torch.clamp(pmin.long() - start[parent_lev], 0, pb_count - 1))
    return tuple(out)


def _degrees(sh: ShardedCSR) -> tuple:
    return tuple(ip[1:] - ip[:-1] for ip in sh.indptr)


def _min_degree_last_level(sh: ShardedCSR, levels) -> torch.Tensor:
    """The least id among the least-degree vertices of the last BFS level,
    a 0-d tensor on the first shard's device (INT32_MAX when no vertex was
    reached): three reductions, no host read."""
    n = sh.shape[0]
    gids, degs = _gids(sh), _degrees(sh)
    valid = [g < n for g in gids]
    lev_max = pmax([torch.where(v, lev, -1).max() for v, lev in zip(valid, levels)])
    on_last = [v & (lev == m) for v, lev, m in zip(valid, levels, lev_max)]
    min_deg = pmin([torch.where(o, dg, _BIG).min() for o, dg in zip(on_last, degs)])
    return pmin([torch.where(o & (dg == m), g, _BIG).min() for o, dg, m, g in zip(on_last, degs, min_deg, gids)])[0]


def rcm_reorder(sh: ShardedCSR, mesh: Mesh, root: int = 0, max_iters: Optional[int] = None, peripheral_iters: int = 2,
                deg_buckets: int = 64, parent_buckets: int = 256, refine_iters: Optional[int] = None,
                max_rank_levels: int = 1024, max_buckets: int = 1 << 22, stats: Optional[dict] = None):
    """Distributed RCM: a pseudo-peripheral root from repeated BFS (each
    pass restarts from a least-degree vertex of the last level), a counting
    rank of (level, degree bucket), then ``refine_iters`` passes (default:
    one per level, at most 64) that re-rank by (level, least parent rank
    within the parent level, degree bucket); the reached span is reversed
    and unreached vertices follow. The bucket budget halves the parent and
    degree buckets until ``(L+1)·PB·B`` fits ``max_buckets``. Returns the
    int32 inverse permutation ``order[old] = new``; ``stats``, a dict,
    receives the BFS passes' ``levels`` and ``host_reads`` (the refinement
    reads nothing back), ``refine_iters`` and ``rank_buckets``, the
    histogram width of a refinement pass (each ``all_gather`` stacks D of
    them)."""
    _require_halo(sh)
    _shards(sh, mesh)
    for _ in range(max(peripheral_iters, 1)):
        levels, _ = _bfs_sharded(sh, root, mesh, max_iters, stats)
        root = _min_degree_last_level(sh, levels)
    levels, nl = _bfs_sharded(sh, root, mesh, max_iters, stats)
    if refine_iters is None:
        refine_iters = min(nl, 64)
    lev_count = min(int(max_rank_levels), nl + 1)
    deg_b, par_b = int(deg_buckets), int(parent_buckets)
    while (lev_count + 1) * par_b * deg_b > int(max_buckets) and par_b > 2:
        par_b //= 2
    while (lev_count + 1) * par_b * deg_b > int(max_buckets) and deg_b > 2:
        deg_b //= 2
    iters = int(max(refine_iters, 0))
    if stats is not None:
        stats.update(refine_iters=iters, rank_buckets=(lev_count + 1) * par_b * deg_b)
    order = _rcm_rank_orchestrator(sh, levels, lev_count, deg_b, par_b, iters)
    return _join(order, mesh, sh.shape[0])


def _rcm_rank_orchestrator(sh: ShardedCSR, levels, L: int, B: int, PB: int, iters: int) -> tuple:
    """The ranks of :func:`rcm_reorder` from the BFS levels, per shard:
    ``iters`` refinement passes, no host read."""
    n = sh.shape[0]
    valid = [g < n for g in _gids(sh)]
    lev_c = [torch.where(lev < 0, L, torch.clamp(lev, max=L - 1)).to(torch.int32) for lev in levels]
    db = [torch.clamp(dg, max=B - 1).to(torch.int32) for dg in _degrees(sh)]
    rank, ghist = _counting_rank(sh, [lc * B + d for lc, d in zip(lev_c, db)], valid, (L + 1) * B)
    # the ranks are level-major: each level's start in rank space, from the
    # valid rows' (level, degree bucket) histogram
    lev_counts = ghist.view(L + 1, B).sum(1)
    level_start = torch.cat([lev_counts.new_zeros((1,)), torch.cumsum(lev_counts, 0)])
    reached = lev_counts[:L].sum()
    slots, sends = _slots(sh), _sends(sh)
    ext_lev = _exchange(levels, sends, sh.axis)
    parents = [(el[slot] == lev[lrow] - 1) & (lev[lrow] > 0) for (lrow, slot), el, lev in zip(slots, ext_lev, levels)]
    for _ in range(iters):
        pb = _parent_bucket(sh, sends, slots, parents, levels, rank, level_start, PB)
        key2 = [((lc * PB + p) * B + d).to(torch.int32) for lc, p, d in zip(lev_c, pb, db)]
        rank, _ = _counting_rank(sh, key2, valid, (L + 1) * PB * B)
    out = []
    for r in rank:
        rc = reached.to(r.device)
        out.append(torch.where(r < rc, rc - 1 - r, r).to(torch.int32))
    return tuple(out)


# -- edge cut and refinement ----------------------------------------------------
def _cut(labels, ext, slots) -> torch.Tensor:
    """The ``psum`` of the shards' entries whose row and column labels
    differ (int64), on the first shard's device."""
    return psum([(lab[lrow] != e[slot]).sum() for lab, e, (lrow, slot) in zip(labels, ext, slots)])[0]


def edge_cut(sh: ShardedCSR, labels, mesh: Mesh):
    """Directed edge cut with sharded labels: one halo exchange of the
    labels and a scalar ``psum`` (int64, on the mesh's first device)."""
    _require_halo(sh)
    _shards(sh, mesh)
    lab = _put(sh, labels, dtype=torch.int32)
    return _cut(lab, _exchange(lab, _sends(sh), sh.axis), _slots(sh)).to(mesh.first_device)


def _wrap_int32(t: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32 as int32 arithmetic wraps them."""
    return ((t + 2**31) % 2**32 - 2**31).to(torch.int32)


def _refine_round(sh, slots, lab, ext, sizes, weights, gids, k: int, cap, G: int) -> list:
    """One round of :func:`refine_partition` on the labels ``lab`` (their
    halo exchange ``ext``, their part sizes ``sizes``): the new labels."""
    n, rows = sh.shape[0], sh.rows_per_shard
    nbk = k * (G + 1)
    state, whists = [], []
    for j, dev in enumerate(sh.devices):
        lrow, slot = slots[j]
        counts = torch.zeros((rows * k,), dtype=torch.int32, device=dev).index_add_(
            0, lrow * k + ext[j][slot].long(), torch.ones_like(lrow, dtype=torch.int32)).view(rows, k)
        cur, w, in_range = lab[j].long(), weights[j], gids[j] < n
        cap_j, size = cap.to(dev), sizes[j]
        cur_aff = counts.gather(1, cur[:, None])[:, 0]
        masked = torch.where((size >= cap_j)[None, :], -_BIG, counts)
        masked.scatter_(1, cur[:, None], -_BIG)
        best = torch.argmax(masked, dim=1)  # the first of equal counts, as XLA's
        gain = torch.where(in_range, _wrap_int32(masked.max(dim=1).values.long() - cur_aff.long()), -1)
        keeps_alive = size[cur.clamp(0, k - 1)] - w > _f32(1e-6, dev)
        mover = in_range & keeps_alive & (gain > 0)
        bucket = torch.where(mover, best * (G + 1) + torch.clamp(gain, 0, G), nbk).to(torch.int32)
        whists.append(torch.zeros((nbk + 1,), dtype=torch.float32, device=dev).index_add_(
            0, bucket.long(), torch.where(mover, w, 0.0))[:nbk])
        state.append((cur, w, best, mover, bucket, torch.clamp(cap_j - size, min=0.0)))
    # admission in weight units: a mover's place is the weight of higher-gain
    # movers into its part, of its bucket's movers on earlier shards, and of
    # those before it in its bucket on its shard
    gathered = all_gather(whists)
    new = []
    for j, (g, (cur, w, best, mover, bucket, headroom)) in enumerate(zip(gathered, state)):
        ghist = g.sum(0).view(k, G + 1)
        rev = torch.cumsum(ghist.flip(1), 1).flip(1)
        higher = torch.cat([rev[:, 1:], torch.zeros_like(rev[:, :1])], 1).reshape(-1)
        # the local prefix: one K5 sort of the buckets, each run's first
        # exclusive prefix (K3 gives the runs' starts) taken off. Float32
        # sums of integer weights below 2**24 are exact; other weights may
        # round otherwise than XLA's sums
        perm, b_s = radix_argsort(bucket, key_bits=bits_below(nbk + 1), return_keys=True)
        perm = perm.long()
        w_s = w[perm]
        ex = torch.cumsum(w_s, 0) - w_s
        prefix_s = ex - ex[indptr_from_sorted_rows(b_s, nbk + 1)[b_s.long()]]
        local_prefix = torch.empty_like(prefix_s)
        local_prefix[perm] = prefix_s
        flat = torch.clamp(bucket.long(), 0, nbk - 1)
        wpos = higher[flat] + g[:j].sum(0)[flat] + local_prefix
        admit = mover & (wpos + w <= headroom[best.clamp(0, k - 1)] + _f32(1e-6, w.device))
        new.append(torch.where(admit, best, cur).to(torch.int32))
    return new


def refine_partition(sh: ShardedCSR, labels, k: int, mesh: Mesh, rounds: int = 4, balance: float = 1.1,
                     gain_buckets: int = 32, vertex_weights=None):
    """Boundary refinement with sharded labels and distributed admission: a
    round moves each vertex of positive gain toward its best part with room,
    movers ranked per target part by (gain bucket, shard, local weighted
    prefix) through an ``all_gather`` of the (part, gain bucket) weight
    histograms, and admitted while they fit the part's headroom.
    ``vertex_weights`` (n,) measures the parts by weight. The best labelling
    seen is kept, feasibility first, then cut, chosen on the device. Returns
    the (n,) int32 labels."""
    _require_halo(sh)
    n, d, rows, _ = _shards(sh, mesh)
    first = mesh.first_device
    weights, total = _weights(sh, vertex_weights, mesh)
    cap = _f32(balance * total / k, first)
    gids, slots, sends = _gids(sh), _slots(sh), _sends(sh)
    lab = _put(sh, labels, dtype=torch.int32)
    ext = _exchange(lab, sends, sh.axis)
    sizes = _sizes(lab, weights, gids, n, k)
    best_lab, best_cut, best_over = lab, _cut(lab, ext, slots), (sizes[0] - cap).max()
    tol = _f32(1e-4, first)
    for _ in range(rounds):
        lab = _refine_round(sh, slots, lab, ext, sizes, weights, gids, k, cap, int(gain_buckets))
        ext = _exchange(lab, sends, sh.axis)
        sizes = _sizes(lab, weights, gids, n, k)
        cut, over = _cut(lab, ext, slots), (sizes[0] - cap).max()
        # feasibility first (a lower cut must not excuse a cap violation), then cut
        feas_new, feas_best = over <= tol, best_over <= tol
        better = (feas_new & ~feas_best) | ((feas_new == feas_best) & ((cut < best_cut) | (~feas_new & (over < best_over))))
        best_lab = [torch.where(better.to(a.device), a, b) for a, b in zip(lab, best_lab)]
        best_cut = torch.where(better, cut, best_cut)
        best_over = torch.where(better, over, best_over)
    return _join(best_lab, mesh, n)
