"""Halo-exchange distributed functions: boundary-proportional communication.

Counterpart of ``sparsebase_tpu/parallel/halo.py``. The functions of
:mod:`.dist` exchange dense ``(n,)`` vectors
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
* :func:`heavy_edge_matching` — handshake rounds (a float32 scatter-max,
  ties by a Luby hash wrapped as int32), two exchanges a round
* :func:`coarsen` — a matching contracted: coarse ids by a prefix count and
  an ``all_gather`` of the shards' counts, two exchanges of them, the
  relabelled entries through :meth:`ShardedCSR.from_coo_sharded`'s route
* :func:`bfs_levels_multilevel`, :func:`rcm_reorder_ml` — a ladder of
  pattern matchings and contractions, the exact BFS on the coarsest graph,
  levels projected back up and relaxed (:func:`_level_correct`); the RCM
  rank of those levels (:func:`.dist._rcm_rank`, K5)
* :func:`multilevel_partition` — the V-cycle: the ladder,
  :func:`_coarsest_init` (the host's region growing and refinement, or label
  propagation past 4096 vertices), refinement at every level by vertex
  weight, :func:`_enforce_balance` on the host
* :func:`slashburn_reorder` — distributed SlashBurn rounds
  (:func:`_active_degree`, the counting rank, :func:`_nbr_min`, the
  components), compaction by re-sharding, and graphkit's ``slashburn`` for
  the host-sized residual

Gathers clamp and scatters drop an index out of range, as JAX's do: on a
matrix with more columns than the shards have rows, a column past the last
shard's rows maps past its owner's rows.

The JAX ``while_loop`` s are host loops that read one flag back a step (a
BFS level, a components round, a pointer jump; ``stats=`` counts them); the
``fori_loop`` s of label propagation, the rank refinement, the partition
refinement, the matching and the level correction read nothing back. The
multilevel functions and SlashBurn read back what sizes their next step (a
coarse size, a route's loads, a round's largest degree, the host's share of
SlashBurn) and count it in ``stats=``.

On a mesh that spans processes every function runs, each process working
on its own shards (``None`` in a remote shard's slot; a loop over the
local shards keeps the global shard index) and every collective naming the
shards' owners. Each gives every process the single-process mesh's result
and ``stats`` bit for bit: a "go on?" flag is global (one ``pmax`` a BFS
level, one read of a ``pmax`` and a ``psum`` a SlashBurn round), a
replicated vector (the components' labels, a matching, a coarse map) is
joined from every process's shards, and the host steps (the coarsest
graph's partition, the balance pass, SlashBurn's bookkeeping and graphkit
tail) run on every process on the same gathered data.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..formats.csr import CSR
from ..ops.kernels.csr_spmv import csr_spmv
from ..ops.kernels.indptr import indptr_from_sorted_rows
from ..ops.kernels.radix import bits_below, radix_argsort
from ..utils.logger import Logger
from ..utils.tracing import span
from .collectives import all_gather, all_to_all, join, pmax, pmin, psum
from .dist import _local_row_of, _rcm_rank, _shards, degrees
from .mesh import Mesh
from .sharded import ShardedCSR

_BIG = 2**31 - 1


def _require_halo(sh: ShardedCSR):
    if not sh.has_halo:
        raise ValueError("this function needs halo metadata — build the ShardedCSR with halo=True or call .with_halo()")


def _exchange(x_local: Sequence[torch.Tensor], halo_send_l: Sequence[torch.Tensor], axis: str = "x", owners=None):
    """One halo exchange: each shard's extended local vector ``[R local
    values | D*S received halo values]``, whose slots match ``halo_map``
    (the slot of (owner o, j) is ``R + o*S + j``).

    ``x_local``: the shards' (R,) vectors and ``halo_send_l`` their (D, S)
    lists of rows in [0, R) (:func:`_sends`), in the order of the mesh
    axis ``axis``; on a mesh that spans processes ``owners`` gives the
    shards' ranks and a remote shard's slots are ``None``. One
    ``all_to_all`` of (D, S) values."""
    sends = [None if x is None else torch.index_select(x, 0, hs.reshape(-1)).view(hs.shape)
             for x, hs in zip(x_local, halo_send_l)]
    with span("sbtorch:halo:exchange"):
        recv = all_to_all(sends, owners=owners)
    return tuple(None if x is None else torch.cat([x, r.reshape(-1)]) for x, r in zip(x_local, recv))


def _each(fn, *parts) -> list:
    """``fn`` of each shard's items of ``parts`` (sequences in shard order),
    ``None`` in a remote shard's slot (where the first part holds ``None``)."""
    return [None if items[0] is None else fn(*items) for items in zip(*parts)]


def _wide(sh: ShardedCSR) -> bool:
    """Whether a column can lie past the shards' rows (more columns than
    d·R): its owner, the last shard, lists it past its rows."""
    return sh.shape[1] > sh.n_shards * sh.rows_per_shard


def _sends(sh: ShardedCSR) -> tuple:
    """The shards' ``halo_send`` lists for :func:`_exchange`: a listed row
    past R reads row R - 1, as the JAX gather clamps it."""
    rows = sh.rows_per_shard
    return tuple(None if hs is None else hs.clamp(max=rows - 1) for hs in sh.halo_send) if _wide(sh) else sh.halo_send


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
    ``fill``, each on its shard's device (``None`` for another process's)."""
    _, n, d, rows, _, _ = _statics(sh)
    x = torch.as_tensor(x)
    if dtype is not None:
        x = x.to(dtype)
    local = sh.local
    return tuple(None if k not in local else p.to(dev)
                 for k, (p, dev) in enumerate(zip(_pad_vec(x, d, rows, n, fill).unbind(0), sh.devices)))


def _join(parts, mesh: Mesh, n: int) -> torch.Tensor:
    """The shards' (R,) pieces joined in row order on the mesh's first
    device, cut to n; across processes the remote pieces are gathered."""
    return join(parts, mesh.axis_owners(mesh.axis_names[0]), mesh.first_device)[:n]


def _gids(sh: ShardedCSR) -> tuple:
    """Each shard's global row ids (int64), ``None`` for a remote shard."""
    rows, local = sh.rows_per_shard, sh.local
    return tuple(k * rows + torch.arange(rows, device=dev) if k in local else None for k, dev in enumerate(sh.devices))


def _slots(sh: ShardedCSR, drop: bool = False) -> list:
    """Each shard's true entries: ``(local row, slot in the extended
    vector)``, int64; ``None`` for a remote shard. A slot past the extended
    vector (a column past the last shard's rows) becomes its last slot, as
    a gather clamps it, or with ``drop`` one past it, a discard slot for a
    scatter."""
    _, n, d, rows, _, s = _statics(sh)
    ext_len = rows + d * s
    wide = _wide(sh)
    out = [None] * d
    for k in sh.local:
        cnt = sh.nnz_counts[k]
        slot = sh.halo_map[k][:cnt].long()
        if wide:
            slot = slot.clamp(max=ext_len if drop else ext_len - 1)
        out[k] = (_local_row_of(sh.indptr[k], cnt), slot)
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


def _sizes(labels, weights, gids, n: int, k: int, owners) -> tuple:
    """Each part's weight (float32), ``psum``'d over the shards' rows below n."""
    return psum(_each(lambda lab, w, g: torch.zeros((k,), dtype=torch.float32, device=lab.device).index_add_(
        0, lab.long(), torch.where(g < n, w, 0.0)), labels, weights, gids), owners)


# -- SpMV -----------------------------------------------------------------------
def spmv(sh: ShardedCSR, x, mesh: Mesh):
    """y = A @ x with A row-sharded and x sharded (not replicated): the
    remote entries of x arrive through the halo ``all_to_all``; then K2 on
    each shard's local CSR whose columns are its ``halo_map`` slots. y is
    joined in row order on the mesh's first device."""
    _require_halo(sh)
    n, d, rows, _ = _shards(sh, mesh)
    ext_len = rows + d * sh.halo_width
    ext = _exchange(_put(sh, x), _sends(sh), sh.axis, sh.owners)
    wide = _wide(sh)
    ys = [None] * d
    for k in sh.local:
        cnt = sh.nnz_counts[k]
        cols = sh.halo_map[k][:cnt]
        if wide:
            cols = cols.clamp(max=ext_len - 1)
        vals = None if sh.vals is None else sh.vals[k][:cnt]
        ys[k] = csr_spmv(CSR(sh.indptr[k], cols, vals, (rows, ext_len)), ext[k])
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
    owners, local = sh.owners, sh.local
    slots = _slots(sh, drop=True)
    sends = _each(torch.Tensor.long, sh.halo_send)
    frontier = _each(lambda g: g == (root.to(g.device) if isinstance(root, torch.Tensor) else root), _gids(sh))
    levels = _each(lambda f: torch.where(f, 0, -1).to(torch.int32), frontier)
    it = reads = 0
    while it < iters:
        reads += 1
        # "any frontier left?" over every shard of every process: one flag
        # (a pmax of the shards' flags), read once
        flags = pmax(_each(lambda f: f.any().to(torch.int32), frontier), owners)
        if not bool(flags[local[0]]):
            break
        # active rows mark their neighbours' slots (a discard slot at the end)
        ext = [None] * d
        for k in local:
            f, (lrow, slot) = frontier[k], slots[k]
            e = torch.zeros((ext_len + 1,), dtype=torch.bool, device=f.device)
            ext[k] = e.index_fill_(0, torch.where(f[lrow], slot, ext_len), True)
        # the marks on owner o's vertices go back to o, which marks its rows
        recv = all_to_all(_each(lambda e: e[rows:ext_len].view(d, sh.halo_width), ext), owners=owners)
        nxt = [None] * d
        for k in local:
            e, hs = ext[k], sends[k]
            e.index_fill_(0, torch.where(recv[k] & (hs < rows), hs, ext_len).reshape(-1), True)
            nxt[k] = e[:rows] & (levels[k] < 0)
            levels[k] = torch.where(nxt[k], it + 1, levels[k])
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
    first, owners = mesh.first_device, sh.owners
    weights, total = _weights(sh, vertex_weights, mesh)
    cap = _f32(balance * total / k, first)
    inv_cap, margin, eps = _f32(1.0, first) / cap, _f32(1.000001, first), _f32(1e-6, first)
    gids, slots, sends = _gids(sh), _slots(sh), _sends(sh)
    degs = _degrees(sh)
    labels = _each(lambda g: torch.clamp(g * k // max(n, 1), max=k - 1).to(torch.int32), gids)
    for it in range(num_iters):
        ext = _exchange(labels, sends, sh.axis, owners)
        sizes = _sizes(labels, weights, gids, n, k, owners)
        new = [None] * d
        for j in sh.local:
            dev, (lrow, slot) = sh.devices[j], slots[j]
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
            new[j] = torch.where(move, best, cur).to(torch.int32)
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
    first, owners, local = mesh.first_device, sh.owners, sh.local
    iters = int(max_iters) if max_iters is not None else n
    if alive is None:
        alive = torch.ones((n,), dtype=torch.bool, device=first)
    alive_flat = _pad_vec(torch.as_tensor(alive, dtype=torch.bool).to(first), d, rows, n, fill=False).view(-1)
    alive_l = tuple(a.to(dev) if k in local else None
                    for k, (a, dev) in enumerate(zip(alive_flat.view(d, rows), sh.devices)))
    slots, sends = _slots(sh), _sends(sh)
    top = d * rows - 1
    labels = torch.where(alive_flat, torch.arange(d * rows, dtype=torch.int32, device=first), _BIG)
    changed, rounds, jumps = True, 0, 0
    while changed and rounds < iters:
        masked = _each(lambda a, lab: torch.where(a, lab.to(a.device), _BIG), alive_l, labels.view(d, rows))
        ext = _exchange(masked, sends, sh.axis, owners)
        new = [None] * d
        for j in local:
            lrow, slot = slots[j]
            nbr_min = torch.full((rows,), _BIG, dtype=torch.int32, device=masked[j].device).scatter_reduce_(
                0, lrow, ext[j][slot], "amin")
            new[j] = torch.where(alive_l[j], torch.minimum(masked[j], nbr_min), _BIG)
        # every process holds the whole (d·R,) vector and runs the same
        # hooking and jumps on it: no further collective, the same reads
        nf = join(new, owners, first)
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
    the earlier shards' counts. Invalid rows rank as INT32_MAX. ``None``
    in a remote shard's slot, in and out."""
    local = [None] * len(bucket)
    for k in sh.local:
        b, v = bucket[k], valid[k]
        perm, b_s = radix_argsort(b, key_bits=bits_below(nb), return_keys=True)
        perm = perm.long()
        starts = indptr_from_sorted_rows(b_s, nb)
        seen = torch.cumsum(torch.cat([v.new_zeros((1,)), v[perm]]), 0)
        hist = (seen[starts[1:]] - seen[starts[:-1]]).to(torch.int32)
        local_rank = torch.empty_like(perm)
        local_rank[perm] = torch.arange(perm.shape[0], device=perm.device) - starts[b_s.long()]
        local[k] = (hist, local_rank)
    gathered = all_gather(_each(lambda loc: loc[0], local), sh.owners)
    ranks = [None] * len(bucket)
    for k in sh.local:
        # k is the global shard index: g[:k] are the earlier shards' counts
        b, v, g, local_rank = bucket[k].long(), valid[k], gathered[k], local[k][1]
        ghist = g.sum(0)
        goffset = torch.cumsum(ghist, 0) - ghist
        pos = goffset[b] + g[:k].sum(0)[b] + local_rank
        ranks[k] = torch.where(v, pos, _BIG).to(torch.int32)
    return tuple(ranks), gathered[sh.local[0]].sum(0)


def _parent_bucket(sh: ShardedCSR, sends, slots, parents, levels, rank, level_start, pb_count: int):
    """Per row the least rank among its BFS parents (one exchange of the
    ranks and a scatter-min), rebased to the parent level's start in rank
    space and clipped to [0, pb_count). ``parents``: per shard, which
    entries join a row to a vertex one level up (the levels do not change,
    so their exchange is made once by the caller)."""
    rows = sh.rows_per_shard
    ext_rank = _exchange(rank, sends, sh.axis, sh.owners)
    out = [None] * sh.n_shards
    for k in sh.local:
        (lrow, slot), par, lev, er = slots[k], parents[k], levels[k], ext_rank[k]
        cand = torch.where(par, er[slot], _BIG)
        pmin = torch.full((rows,), _BIG, dtype=torch.int32, device=lev.device).scatter_reduce_(0, lrow, cand, "amin")
        start = level_start.to(lev.device)
        parent_lev = torch.clamp(lev.long() - 1, 0, start.shape[0] - 1)
        out[k] = torch.clamp(pmin.long() - start[parent_lev], 0, pb_count - 1)
    return tuple(out)


def _degrees(sh: ShardedCSR) -> tuple:
    return tuple(_each(lambda ip: ip[1:] - ip[:-1], sh.indptr))


def _min_degree_last_level(sh: ShardedCSR, levels) -> torch.Tensor:
    """The least id among the least-degree vertices of the last BFS level,
    a 0-d tensor on the first shard's device (INT32_MAX when no vertex was
    reached): three reductions, no host read."""
    n, owners = sh.shape[0], sh.owners
    gids, degs = _gids(sh), _degrees(sh)
    valid = _each(lambda g: g < n, gids)
    lev_max = pmax(_each(lambda v, lev: torch.where(v, lev, -1).max(), valid, levels), owners)
    on_last = _each(lambda v, lev, m: v & (lev == m), valid, levels, lev_max)
    min_deg = pmin(_each(lambda o, dg: torch.where(o, dg, _BIG).min(), on_last, degs), owners)
    return pmin(_each(lambda o, dg, m, g: torch.where(o & (dg == m), g, _BIG).min(), on_last, degs, min_deg, gids),
                owners)[sh.local[0]]


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
    valid = _each(lambda g: g < n, _gids(sh))
    lev_c = _each(lambda lev: torch.where(lev < 0, L, torch.clamp(lev, max=L - 1)).to(torch.int32), levels)
    db = _each(lambda dg: torch.clamp(dg, max=B - 1).to(torch.int32), _degrees(sh))
    rank, ghist = _counting_rank(sh, _each(lambda lc, d: lc * B + d, lev_c, db), valid, (L + 1) * B)
    # the ranks are level-major: each level's start in rank space, from the
    # valid rows' (level, degree bucket) histogram
    lev_counts = ghist.view(L + 1, B).sum(1)
    level_start = torch.cat([lev_counts.new_zeros((1,)), torch.cumsum(lev_counts, 0)])
    reached = lev_counts[:L].sum()
    slots, sends = _slots(sh), _sends(sh)
    ext_lev = _exchange(levels, sends, sh.axis, sh.owners)
    parents = _each(lambda s, el, lev: (el[s[1]] == lev[s[0]] - 1) & (lev[s[0]] > 0), slots, ext_lev, levels)
    for _ in range(iters):
        pb = _parent_bucket(sh, sends, slots, parents, levels, rank, level_start, PB)
        key2 = _each(lambda p, lc, d: ((lc * PB + p) * B + d).to(torch.int32), pb, lev_c, db)
        rank, _ = _counting_rank(sh, key2, valid, (L + 1) * PB * B)
    return tuple(_each(lambda r: torch.where(r < reached.to(r.device), reached.to(r.device) - 1 - r, r)
                       .to(torch.int32), rank))


# -- edge cut and refinement ----------------------------------------------------
def _cut(labels, ext, slots, owners) -> torch.Tensor:
    """The ``psum`` of the shards' entries whose row and column labels
    differ (int64), on this process's first shard's device."""
    parts = _each(lambda lab, e, s: (lab[s[0]] != e[s[1]]).sum(), labels, ext, slots)
    return next(p for p in psum(parts, owners) if p is not None)


def edge_cut(sh: ShardedCSR, labels, mesh: Mesh):
    """Directed edge cut with sharded labels: one halo exchange of the
    labels and a scalar ``psum`` (int64, on the mesh's first device)."""
    _require_halo(sh)
    _shards(sh, mesh)
    lab = _put(sh, labels, dtype=torch.int32)
    return _cut(lab, _exchange(lab, _sends(sh), sh.axis, sh.owners), _slots(sh), sh.owners).to(mesh.first_device)


def _wrap_int32(t: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32 as int32 arithmetic wraps them."""
    return ((t + 2**31) % 2**32 - 2**31).to(torch.int32)


def _refine_round(sh, slots, lab, ext, sizes, weights, gids, k: int, cap, G: int) -> list:
    """One round of :func:`refine_partition` on the labels ``lab`` (their
    halo exchange ``ext``, their part sizes ``sizes``): the new labels."""
    n, rows, d = sh.shape[0], sh.rows_per_shard, sh.n_shards
    nbk = k * (G + 1)
    state, whists = [None] * d, [None] * d
    for j in sh.local:
        dev, (lrow, slot) = sh.devices[j], slots[j]
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
        whists[j] = torch.zeros((nbk + 1,), dtype=torch.float32, device=dev).index_add_(
            0, bucket.long(), torch.where(mover, w, 0.0))[:nbk]
        state[j] = (cur, w, best, mover, bucket, torch.clamp(cap_j - size, min=0.0))
    # admission in weight units: a mover's place is the weight of higher-gain
    # movers into its part, of its bucket's movers on earlier shards, and of
    # those before it in its bucket on its shard
    gathered = all_gather(whists, sh.owners)
    new = [None] * d
    for j in sh.local:
        # j is the global shard index: g[:j] are the earlier shards' weights
        g, (cur, w, best, mover, bucket, headroom) = gathered[j], state[j]
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
        new[j] = torch.where(admit, best, cur).to(torch.int32)
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
    first, owners, l0 = mesh.first_device, sh.owners, sh.local[0]
    weights, total = _weights(sh, vertex_weights, mesh)
    cap = _f32(balance * total / k, first)
    gids, slots, sends = _gids(sh), _slots(sh), _sends(sh)
    lab = _put(sh, labels, dtype=torch.int32)
    ext = _exchange(lab, sends, sh.axis, owners)
    sizes = _sizes(lab, weights, gids, n, k, owners)
    # the cut and the sizes are replicated: every process keeps the same best
    best_lab, best_cut, best_over = lab, _cut(lab, ext, slots, owners), (sizes[l0] - cap).max()
    tol = _f32(1e-4, first)
    for _ in range(rounds):
        lab = _refine_round(sh, slots, lab, ext, sizes, weights, gids, k, cap, int(gain_buckets))
        ext = _exchange(lab, sends, sh.axis, owners)
        sizes = _sizes(lab, weights, gids, n, k, owners)
        cut, over = _cut(lab, ext, slots, owners), (sizes[l0] - cap).max()
        # feasibility first (a lower cut must not excuse a cap violation), then cut
        feas_new, feas_best = over <= tol, best_over <= tol
        better = (feas_new & ~feas_best) | ((feas_new == feas_best) & ((cut < best_cut) | (~feas_new & (over < best_over))))
        best_lab = _each(lambda a, b: torch.where(better.to(a.device), a, b), lab, best_lab)
        best_cut = torch.where(better, cut, best_cut)
        best_over = torch.where(better, over, best_over)
    return _join(best_lab, mesh, n)


def _add(stats: Optional[dict], **counts) -> None:
    """Add ``counts`` into ``stats`` (a dict, or None for no stats)."""
    if stats is not None:
        for key, v in counts.items():
            stats[key] = stats.get(key, 0) + v


def _nbr_ids(sh: ShardedCSR, slots, sends) -> list:
    """Each shard's true entries' neighbour ids (int64), as the JAX bodies
    read them: the global row ids shipped through the halo once, read at
    the entries' slots (a column past the shards' rows reads its clamped
    slot's id)."""
    ext = _exchange(_gids(sh), sends, sh.axis, sh.owners)
    return _each(lambda e, s: e[s[1]], ext, slots)


# -- heavy-edge matching --------------------------------------------------------
def _luby_priority(ids: torch.Tensor, it: int) -> torch.Tensor:
    """Round ``it``'s tie-break priority of the int64 vertex ``ids`` in [0,
    2**31): the JAX body's int32 hash ``((id ^ it * 0x9E3779B9) *
    0xC2B2AE3D) & 0x7FFFFFFF``, whose products wrap. Here the salt is
    wrapped to int32 exactly and the hash taken in int64, whose low 31
    bits are the wrapped product's."""
    salt = (it * -1640531527 + 2**31) % 2**32 - 2**31
    return ((ids ^ salt) * -1028477379) & 0x7FFFFFFF


def _matching_round(sh: ShardedCSR, slots, sends, nb, weights, gids, match, it: int) -> list:
    """One handshake round of :func:`heavy_edge_matching` on the shards'
    (R,) int64 ``match``: each unmatched row proposes to its heaviest
    unmatched neighbour (a float32 scatter-max from -inf; equal weights
    broken by the highest Luby hash of the neighbour id, then the least
    id), and mutual proposals match. Two exchanges: the match state, then
    the proposals. Returns the new match."""
    n, rows, d, owners = sh.shape[0], sh.rows_per_shard, sh.n_shards, sh.owners
    ext_match = _exchange(match, sends, sh.axis, owners)
    proposals = [None] * d
    for k in sh.local:
        (lrow, slot), em, b, w, g, m = slots[k], ext_match[k], nb[k], weights[k], gids[k], match[k]
        unmatched = (m == g) & (g < n)
        cand = unmatched[lrow] & (em[slot] == b) & (b != g[lrow])
        w = torch.where(cand, w, float("-inf"))
        wmax = torch.full((rows,), float("-inf"), dtype=torch.float32, device=w.device).scatter_reduce_(
            0, lrow, w, "amax")
        tie = cand & (w >= wmax[lrow]) & torch.isfinite(w)
        pri = torch.where(tie, _luby_priority(b, it), -1)
        primax = torch.full((rows,), -1, dtype=torch.int64, device=w.device).scatter_reduce_(0, lrow, pri, "amax")
        best = torch.full((rows,), _BIG, dtype=torch.int64, device=w.device).scatter_reduce_(
            0, lrow, torch.where(tie & (pri == primax[lrow]), b, _BIG), "amin")
        proposals[k] = torch.where(unmatched & (best < _BIG), best, _BIG)
    ext_prop = _exchange(proposals, sends, sh.axis, owners)
    new = [None] * d
    for k in sh.local:
        (lrow, slot), ep, b, g, m, p = slots[k], ext_prop[k], nb[k], gids[k], match[k], proposals[k]
        mutual_e = (b == p[lrow]) & (ep[slot] == g[lrow])
        mutual = torch.zeros((rows + 1,), dtype=torch.bool, device=m.device).index_fill_(
            0, torch.where(mutual_e, lrow, rows), True)[:rows]
        new[k] = torch.where(mutual, torch.clamp(p, max=_BIG - 1), m)
    return new


def heavy_edge_matching(sh: ShardedCSR, mesh: Mesh, rounds: int = 4, weighted: bool = True):
    """Distributed heavy-edge matching, the coarsening step of a multilevel
    partitioner: ``rounds`` handshake rounds (:func:`_matching_round`) on
    ``|vals|`` as float32 weights, or on unit weights with ``weighted=False``
    (pattern matching: every edge ties and the randomized priority decides,
    the mode for structural ladders and asymmetric values; with asymmetric
    weights locally dominant edges need not be mutual and the handshake can
    stall). Returns the (n,) int32 ``match[v]``: v's partner, or v when
    unmatched. Reads nothing back."""
    _require_halo(sh)
    n = _shards(sh, mesh)[0]
    slots, sends, gids = _slots(sh), _sends(sh), _gids(sh)
    nb = _nbr_ids(sh, slots, sends)
    if weighted and sh.vals is not None:
        weights = _each(lambda v, c: v[:c].abs().to(torch.float32), sh.vals, sh.nnz_counts)
    else:
        weights = _each(lambda s: torch.ones(s[0].shape, dtype=torch.float32, device=s[0].device), slots)
    match = list(gids)
    for it in range(int(rounds)):
        match = _matching_round(sh, slots, sends, nb, weights, gids, match, it)
    return _join(match, mesh, n).to(torch.int32)


# -- contraction ----------------------------------------------------------------
def coarsen(sh: ShardedCSR, match, mesh: Mesh, halo: bool = True, return_mapping: bool = False,
            stats: Optional[dict] = None):
    """Contract a matching into the coarse graph, distributed: with
    :func:`heavy_edge_matching` one level of multilevel coarsening. A pair
    becomes one coarse vertex (the lower endpoint represents it): each shard
    numbers its representatives by a prefix count, an ``all_gather`` of the
    shards' counts gives their offsets, and the coarse size is read back
    once; a non-representative takes its partner's coarse id through one
    exchange, the entries are relabelled through a second, and an entry
    inside a pair becomes the pad row nc. The shards' blocks of ``width``
    slots (pads row nc) go through :meth:`ShardedCSR.from_coo_blocks`, so
    capacity and widths equal JAX's. Parallel edges are kept,
    their float32 values (ones for a pattern) as the coarse values.

    Returns the coarse ``ShardedCSR`` (with halo lists when ``halo``), and
    with ``return_mapping`` the (n,) int32 fine-to-coarse map. ``stats``, a
    dict, receives ``host_reads``."""
    _require_halo(sh)
    n, d, rows, width = _shards(sh, mesh)
    slots, sends, gids = _slots(sh), _sends(sh), _gids(sh)
    nb = _nbr_ids(sh, slots, sends)
    match_l = _put(sh, match, dtype=torch.int64)
    owners, local = sh.owners, sh.local
    rep = _each(lambda g, m: (g < n) & (g <= m), gids, match_l)
    counts = all_gather(_each(torch.Tensor.sum, rep), owners)
    cid = [None] * d
    for k in local:
        # k is the global shard index: c[:k] are the earlier shards' counts
        r, c = rep[k], counts[k]
        prefix = torch.cumsum(r, 0) - r.long()
        cid[k] = torch.where(r, c[:k].sum() + prefix, -1)
    nc = int(counts[local[0]].sum())
    # a non-representative's partner is a neighbour: its coarse id arrives
    # on the entry that points at it
    ext = _exchange(cid, sends, sh.axis, owners)
    for k in local:
        (lrow, slot), e, b, m = slots[k], ext[k], nb[k], match_l[k]
        partner = torch.full((rows,), _BIG, dtype=torch.int64, device=b.device).scatter_reduce_(
            0, lrow, torch.where(b == m[lrow], e[slot], _BIG), "amin")
        cid[k] = torch.where(rep[k], cid[k], torch.where(partner < _BIG, partner, -1))
    ext = _exchange(cid, sends, sh.axis, owners)
    blocks = ([None] * d, [None] * d, [None] * d)
    for k in local:
        (lrow, slot), e, c = slots[k], ext[k], cid[k]
        cnt, dev = sh.nnz_counts[k], c.device
        cu, cv = c[lrow], e[slot]
        keep = (cu >= 0) & (cv >= 0) & (cu != cv)
        vals = torch.ones((cnt,), dtype=torch.float32, device=dev) if sh.vals is None else sh.vals[k][:cnt].float()
        for out, fill, dtype, part in ((blocks[0], nc, torch.int32, torch.where(keep, cu, nc)),
                                       (blocks[1], 0, torch.int32, torch.where(keep, cv, 0)),
                                       (blocks[2], 0, torch.float32, torch.where(keep, vals, 0.0))):
            out[k] = torch.cat([part.to(dtype), torch.full((width - cnt,), fill, dtype=dtype, device=dev)])
    route = {}
    out = ShardedCSR.from_coo_blocks(*blocks, (nc, nc), mesh, sh.axis, stats=route)
    reads = 1 + route["host_reads"]
    if halo:
        out = out.with_halo()
        reads += 1
    _add(stats, host_reads=reads)
    return (out, _join(cid, mesh, n).to(torch.int32)) if return_mapping else out


# -- the multilevel BFS and RCM -------------------------------------------------
def _level_correct(sh: ShardedCSR, levels, mesh: Mesh, rounds: int) -> torch.Tensor:
    """``rounds`` Bellman-Ford relaxations of the (n,) int32 level field
    ``levels``: ``lev = min(lev, least neighbour level + 1)``, one exchange
    a round; -1 (unreached) stays -1. Reads nothing back."""
    rows = sh.rows_per_shard
    slots, sends = _slots(sh), _sends(sh)

    def relax(s, e, mk, lv):
        nmin = torch.full((rows,), _BIG, dtype=torch.int32, device=lv.device).scatter_reduce_(0, s[0], e[s[1]], "amin")
        return torch.where(lv < 0, -1, torch.minimum(mk, torch.clamp(nmin, max=_BIG - 1) + 1))

    lev = _put(sh, levels, fill=-1, dtype=torch.int32)
    for _ in range(int(rounds)):
        masked = _each(lambda lv: torch.where(lv < 0, _BIG, lv), lev)
        lev = _each(relax, slots, _exchange(masked, sends, sh.axis, sh.owners), masked, lev)
    return _join(lev, mesh, sh.shape[0])


def _project_levels(coarse: torch.Tensor) -> torch.Tensor:
    """A level walked one contraction up, ``2 * level`` (-1 stays -1),
    saturated at INT32_MAX - 1: where the ladder shrinks slowly the doubled
    levels pass 2**31, which JAX's int32 cast wraps to negative values that
    then read as unreached; saturating keeps reachability exact."""
    return torch.where(coarse < 0, -1, torch.clamp(2 * coarse.long(), max=_BIG - 1)).to(torch.int32)


def bfs_levels_multilevel(sh: ShardedCSR, root: int, mesh: Mesh, coarsen_until: int = 4096,
                          correction_rounds: int = 2, matching_rounds: int = 8, max_levels: int = 24,
                          stats: Optional[dict] = None):
    """Approximate BFS levels in fewer synchronous steps than the diameter:
    a ladder of pattern matchings and contractions down to
    ``coarsen_until`` vertices (each level roughly halves the diameter), the
    exact BFS on the coarsest graph, then back up each level projecting
    ``lev = 2 * lev_coarse[map]`` (a device gather) and smoothing with
    ``correction_rounds`` relaxations. The levels are approximate (a level
    can exceed n when the ladder shrinks slowly, and saturates at INT32_MAX
    - 1, :func:`_project_levels`); reachability is exact.

    Returns ``(levels (n,) int32, steps)``: ``steps`` counts the synchronous
    exchanges as JAX counts them (``2 * matching_rounds + 3`` a contraction,
    the coarse BFS's levels, ``correction_rounds`` a level back up).
    ``stats``, a dict, receives ``levels`` (contractions kept), ``sizes``
    (n down the ladder), ``coarse_depth`` and ``host_reads``."""
    _require_halo(sh)
    _shards(sh, mesh)
    reads = {}
    ladder, maps, cur, steps = [sh], [], sh, 0
    while cur.shape[0] > max(int(coarsen_until), 1) and len(maps) < max_levels:
        match = heavy_edge_matching(cur, mesh, rounds=matching_rounds, weighted=False)
        nxt, cid = coarsen(cur, match, mesh, halo=True, return_mapping=True, stats=reads)
        steps += 2 * matching_rounds + 3  # the handshakes and the relabelling exchanges
        if nxt.shape[0] >= cur.shape[0]:
            break  # the matching stalled
        maps.append(cid.long())
        ladder.append(nxt)
        cur = nxt
    r = int(root)
    for cid in maps:  # the root's coarse id, a 1-element view (indexing by a 0-d tensor reads it back)
        r = cid[r : r + 1] if isinstance(r, int) else cid.index_select(0, r)
    lev, depth = _bfs_sharded(cur, r if isinstance(r, int) else r[0], mesh, stats=reads)
    lev = _join(lev, mesh, cur.shape[0])
    steps += depth
    for level in range(len(maps) - 1, -1, -1):
        lev = _level_correct(ladder[level], _project_levels(lev[maps[level]]), mesh, correction_rounds)
        steps += int(correction_rounds)
    if stats is not None:
        stats.update(levels=len(maps), sizes=[s.shape[0] for s in ladder], coarse_depth=depth)
        _add(stats, host_reads=reads["host_reads"])
    return lev, steps


def rcm_reorder_ml(sh: ShardedCSR, mesh: Mesh, root: int = 0, coarsen_until: int = 4096,
                   correction_rounds: int = 2, stats: Optional[dict] = None):
    """RCM-class ordering from :func:`bfs_levels_multilevel`: the rank of
    (level, degree, id) reversed over the reached vertices
    (:func:`.dist._rcm_rank`, K5), the variant for graphs whose diameter
    is large. Returns ``(the (n,) int32 inverse permutation, steps)``;
    ``stats`` as :func:`bfs_levels_multilevel`'s, with the rank's read."""
    levels, steps = bfs_levels_multilevel(sh, root, mesh, coarsen_until=coarsen_until,
                                          correction_rounds=correction_rounds, stats=stats)
    order = _rcm_rank(levels, degrees(sh, mesh), sh.shape[0])
    _add(stats, host_reads=1)
    return order, steps


# -- the multilevel partitioner -------------------------------------------------
def _coarsest_init(sh: ShardedCSR, k: int, mesh: Mesh, vw, balance, lp_iters, stats: Optional[dict] = None):
    """The initial partition of the coarsest V-cycle graph: past 4096
    vertices distributed label propagation with the vertex weights ``vw``;
    else, as METIS solves its coarsest graph, on the host: the graph comes
    back (``to_csr``), is symmetrized, and the best of four weighted region
    growths, each refined, is kept (``np.random.default_rng(0x5EED)`` in
    JAX's call order). Returns (n,) int32 labels on the mesh's first
    device."""
    from ..ops.partition.multilevel import _refine, _region_grow, _symmetrize

    n = sh.shape[0]
    if n > 4096:
        _add(stats, host_reads=1)  # the weights' total
        return label_prop_partition(sh, k, mesh, num_iters=lp_iters, balance=balance, vertex_weights=vw)
    csr = sh.to_csr()
    indptr = csr.indptr.cpu().numpy().astype(np.int64)
    indices = csr.indices.cpu().numpy().astype(np.int64)
    ew = np.ones(csr.nnz, np.float64) if csr.vals is None else np.abs(csr.vals.cpu().numpy()).astype(np.float64)
    ip, ix, ew = _symmetrize(indptr, indices, ew, n)
    vwts = torch.as_tensor(vw).cpu().numpy().astype(np.float64)[:n]
    _add(stats, host_reads=3 + (csr.vals is not None), host_writes=1)
    cap = balance * float(vwts.sum()) / k
    rng = np.random.default_rng(0x5EED)
    best_lab, best_cut = None, None
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(ip))
    for _ in range(4):
        lab = _region_grow(ip, ix, ew, vwts, k, rng, cap)
        lab = _refine(ip, ix, ew, vwts, lab, k, cap, rounds=8, rng=rng)
        c = float(ew[lab[row] != lab[ix]].sum())
        if best_cut is None or c < best_cut:
            best_lab, best_cut = lab, c
    return torch.as_tensor(best_lab.astype(np.int32)).to(mesh.first_device)


def multilevel_partition(sh: ShardedCSR, k: int, mesh: Mesh, coarsen_until: int = 256, max_levels: int = 8,
                         lp_iters: int = 20, refine_rounds: int = 6, balance: float = 1.1,
                         stats: Optional[dict] = None):
    """Distributed multilevel k-way partitioning (a V-cycle): a ladder of
    :func:`heavy_edge_matching` and :func:`coarsen` down to
    ``coarsen_until`` vertices (stopping when a level shrinks by less than
    5%), :func:`_coarsest_init` and :func:`refine_partition` on the
    coarsest graph, then back up: each level's labels are its coarse
    vertices' (a device gather), refined at that level. A coarse vertex
    weighs the float32 sum of its fine vertices (exact below 2**24), and
    every level balances by weight. :func:`_enforce_balance` ends it.
    Returns the (n,) int32 labels on the mesh's first device. ``stats``, a
    dict, receives ``levels``, ``sizes``, ``host_reads`` and
    ``host_writes``."""
    _require_halo(sh)
    n = _shards(sh, mesh)[0]
    counts = {}
    ladder, maps = [sh], []
    weights = [torch.ones((n,), dtype=torch.float32, device=mesh.first_device)]
    cur = sh
    for _ in range(max_levels):
        if cur.shape[0] <= coarsen_until:
            break
        m = heavy_edge_matching(cur, mesh, rounds=6)
        nxt, cid = coarsen(cur, m, mesh, return_mapping=True, stats=counts)
        if nxt.shape[0] >= int(cur.shape[0] * 0.95):
            break  # the matching stalled
        maps.append(cid.long())
        weights.append(torch.zeros((nxt.shape[0],), dtype=torch.float32, device=mesh.first_device).index_add_(
            0, maps[-1], weights[-1]))
        ladder.append(nxt)
        cur = nxt
    labels = _coarsest_init(cur, k, mesh, weights[-1], balance, lp_iters, stats=counts)
    labels = refine_partition(cur, labels, k, mesh, rounds=refine_rounds, balance=balance, vertex_weights=weights[-1])
    for level in range(len(maps) - 1, -1, -1):
        labels = refine_partition(ladder[level], labels[maps[level]], k, mesh, rounds=refine_rounds, balance=balance,
                                  vertex_weights=weights[level])
    _add(counts, host_reads=len(maps) + 1)  # each refinement reads its weights' total
    labels = _enforce_balance(sh, labels, k, mesh, balance, stats=counts)
    if stats is not None:
        stats.update(levels=len(maps), sizes=[s.shape[0] for s in ladder])
        _add(stats, host_reads=counts.get("host_reads", 0), host_writes=counts.get("host_writes", 0))
    return labels


def _enforce_balance(sh: ShardedCSR, labels, k: int, mesh: Mesh, balance: float, stats: Optional[dict] = None):
    """The final balance guarantee of :func:`multilevel_partition`, a host
    post-pass (METIS's ``ufactor`` contract): when refinement cannot reach
    the cap (a hub cluster contracted into a coarse vertex heavier than
    it), the lowest-degree members of over-cap parts move to the lightest
    parts until every part fits. Labels within the cap come back as they
    are; an infeasible cap (every part at ``floor(cap)``) logs a warning
    and returns the best effort. Returns (n,) int32 labels on the mesh's
    first device."""
    n = sh.shape[0]
    labels = torch.as_tensor(labels).to(mesh.first_device)
    lab = labels.cpu().numpy().reshape(-1)[:n].astype(np.int32)
    _add(stats, host_reads=1)
    cap = balance * n / k
    sizes = np.bincount(lab, minlength=k).astype(np.int64)
    if sizes.max() <= cap:
        return labels.reshape(-1)[:n].to(torch.int32)
    deg = degrees(sh, mesh).cpu().numpy()[:n]
    for p in np.argsort(-sizes):
        excess = int(sizes[p] - np.floor(cap))
        if excess <= 0:
            continue
        members = np.nonzero(lab == p)[0]
        movers = members[np.argsort(deg[members], kind="stable")][:excess]
        for v in movers:
            if sizes[p] <= cap:
                break
            tgt = int(np.argmin(np.where(np.arange(k) == p, np.iinfo(np.int64).max, sizes)))
            if sizes[tgt] + 1 > cap:
                break  # nowhere to put it without overflowing the target
            lab[v] = tgt
            sizes[p] -= 1
            sizes[tgt] += 1
    if sizes.max() > cap:
        # only when every part sits at the integer cap (floor(cap) * k < n):
        # say so rather than hand back an over-cap labelling silently
        Logger(type(sh)).warning(f"enforce_balance: infeasible at k={k} balance={balance:.3f} (max part "
                                 f"{int(sizes.max())} > cap {cap:.1f}); returning best effort")
    _add(stats, host_reads=1, host_writes=1)
    return torch.as_tensor(lab).to(mesh.first_device)


# -- SlashBurn ------------------------------------------------------------------
def _active_degree(sh: ShardedCSR, alive) -> tuple:
    """Each row's degree (int32) in the subgraph induced by ``alive`` (the
    shards' (R,) bool pieces): one exchange of the mask, then each row's
    count of live entries from a running count read at its bounds."""
    ext = _exchange(_each(lambda a: a.to(torch.int32), alive), _sends(sh), sh.axis, sh.owners)

    def degree(s, a, e, ip):
        seen = torch.cumsum(F.pad(a[s[0]] & (e[s[1]] > 0), (1, 0)), 0)
        return (seen[ip[1:]] - seen[ip[:-1]]).to(torch.int32)

    return tuple(_each(degree, _slots(sh), alive, ext, sh.indptr))


def _nbr_min(sh: ShardedCSR, vals) -> tuple:
    """Each row's least neighbour value (the shards' (R,) int32 ``vals``,
    one exchange and a scatter-min); a row without entries gets
    INT32_MAX."""
    ext = _exchange(vals, _sends(sh), sh.axis, sh.owners)
    return tuple(_each(lambda s, e: torch.full((sh.rows_per_shard,), _BIG, dtype=torch.int32, device=e.device)
                       .scatter_reduce_(0, s[0], e[s[1]], "amin"), _slots(sh), ext))


def slashburn_reorder(sh: ShardedCSR, mesh: Mesh, k_size: int = 64, hub_order: bool = False, bucket_cap: int = 4096,
                      host_tail: int = 65536, host_tail_nnz: int = 2 << 20, compact_ratio: float = 0.5,
                      stats: Optional[dict] = None):
    """Distributed SlashBurn, the reference's non-greedy variant
    (``SlashburnReorder(greedy=False)``, whose order it equals on a
    symmetric adjacency): the k highest-degree hubs go to the front, the
    components other than the giant one to the back, and the giant
    component recurses.

    A round on the mesh: the active degrees (:func:`_active_degree`), one
    read of (largest degree, live entries), the hubs by a counting rank of
    descending degree (:func:`_counting_rank`: K5 with ``bits_below(nb)``
    and K3 per shard; ``nb`` sized from the largest degree, at least
    ``bucket_cap``, so no degree clips), ``hub_order``'s discovering hub
    (:func:`_nbr_min`), then :func:`connected_components` of the rest. The
    host keeps the O(n) position bookkeeping. Rounds run in phases: when
    the live entries fall below ``compact_ratio`` of the phase's first
    round, the active subgraph is compacted and re-sharded
    (``ShardedCSR.from_csr`` on the mesh); once the residual is host-sized
    (``host_tail`` vertices or ``host_tail_nnz`` live entries) graphkit's
    ``slashburn`` finishes it, else the numpy route. 0 turns a tier off.

    Returns the (n,) int32 inverse permutation on the mesh's first device.
    ``stats``, a dict, receives ``rounds`` (on the mesh), ``phases``,
    ``compactions``, ``host_tail`` (the vertices finished on the host),
    ``host_reads`` and ``host_writes`` (the masks copied to the card)."""
    from .. import native
    from ..ops.reorder.slashburn import SlashburnReorderParams, _place_spokes, _slashburn_host

    _require_halo(sh)
    _shards(sh, mesh)
    first = mesh.first_device
    k = max(int(k_size), 1)
    nb_min = max(int(bucket_cap), 4)
    n_glob = sh.shape[0]
    counts = dict(rounds=0, phases=0, compactions=0, host_tail=0, host_reads=0, host_writes=0)

    def read(t):
        counts["host_reads"] += 1
        return t.cpu().numpy()

    def write(a):
        counts["host_writes"] += 1
        return torch.as_tensor(a).to(first)

    def host_csr(c):
        hc = c.to_csr()
        return read(hc.indptr).astype(np.int64), read(hc.indices).astype(np.int64)

    def induced(gip, gix, active, count):
        """The subgraph induced by ``active``, ids compacted in order."""
        n_cur = active.shape[0]
        inv_id = np.full(n_cur, -1, np.int64)
        verts = np.nonzero(active)[0]
        inv_id[verts] = np.arange(count)
        row_all = np.repeat(np.arange(n_cur, dtype=np.int64), np.diff(gip))
        keep = active[row_all] & active[gix]
        sub_r, sub_c = inv_id[row_all[keep]], inv_id[gix[keep]]
        sub_ip = np.concatenate([[0], np.cumsum(np.bincount(sub_r, minlength=count))]).astype(np.int64)
        return verts, sub_ip, sub_c

    order = np.full(n_glob, -1, np.int64)
    front, back = 0, n_glob - 1
    cur = sh
    vmap = np.arange(n_glob, dtype=np.int64)  # local id -> global id
    first_phase = True
    while True:  # phases
        counts["phases"] += 1
        n = cur.shape[0]
        order_l = np.full(n, -1, np.int64)
        active = np.ones(n, bool)

        def cc_host(mask):
            cc = {}
            labels = connected_components(cur, mesh, alive=write(mask), stats=cc)
            counts["host_reads"] += cc["host_reads"]
            return read(labels).astype(np.int64)

        if first_phase:
            # the first spokes: everything outside the giant component (a
            # compacted phase starts from a connected giant component)
            labels = cc_host(active)
            sizes = np.bincount(labels[labels >= 0], minlength=n)
            gcc = int(np.argmax(sizes)) if sizes.size else 0
            back, active = _place_spokes(order_l, labels, active, gcc, back)
            first_phase = False
        nnz_phase = None
        compact = done = host_finish = False
        while True:  # rounds
            count = int(active.sum())
            if count == 0:
                done = True
                break
            if count < k:
                verts = np.nonzero(active)[0]
                order_l[verts] = back - count + 1 + np.arange(count)
                back -= count
                done = True
                break
            if 0 < host_tail >= count or host_finish:
                # the connected residual goes to the host
                gip, gix = host_csr(cur)
                verts, sub_ip, sub_c = induced(gip, gix, active, count)
                if native.available():
                    sub_order = native.slashburn(count, sub_ip, sub_c, k, False, hub_order).numpy()
                else:
                    sub_order = _slashburn_host(sub_ip, sub_c, count, SlashburnReorderParams(k, False, hub_order))
                order_l[verts] = front + np.asarray(sub_order, np.int64)
                counts["host_tail"] = count
                done = True
                break
            counts["rounds"] += 1
            alive = _put(cur, write(active), fill=False)
            deg = _active_degree(cur, alive)
            # one read for both: the histogram's size and the live entries
            # that decide compaction
            owners, l0 = cur.owners, cur.local[0]
            dmax, nnz_act = (int(v) for v in read(torch.stack([pmax(_each(torch.Tensor.max, deg), owners)[l0].long(),
                                                                psum(_each(torch.Tensor.sum, deg), owners)[l0]])))
            if 0 < host_tail_nnz >= nnz_act:
                host_finish = True
                continue
            if nnz_phase is None:
                nnz_phase = max(nnz_act, 1)
            elif compact_ratio > 0 and nnz_act < compact_ratio * nnz_phase:
                compact = True
                break
            nb = max(nb_min, 1 << (dmax + 1).bit_length())
            # descending degree, ascending id among ties (the stable rank);
            # bucket nb - 1 holds the inactive rows
            key = _each(lambda a, dg: torch.where(a, dmax - dg, nb - 1).to(torch.int32), alive, deg)
            rank, _ = _counting_rank(cur, key, alive, nb)
            ranks = read(_join(rank, mesh, n)).astype(np.int64)
            hubs_mask = active & (ranks < k)
            order_l[hubs_mask] = front + ranks[hubs_mask]
            front += k
            active = active & ~hubs_mask
            hub_of = None
            if hub_order:
                hr = _put(cur, write(np.where(hubs_mask, ranks, _BIG).astype(np.int32)), fill=_BIG)
                hub_of = read(_join(_nbr_min(cur, hr), mesh, n)).astype(np.int64)
                hub_of = np.where(hub_of == _BIG, np.iinfo(np.int64).max, hub_of)
            labels = cc_host(active)
            live = labels[labels >= 0]
            if live.size == 0:
                done = True
                break
            sizes = np.bincount(live, minlength=n)
            gcc = int(np.argmax(sizes))
            back, active = _place_spokes(order_l, labels, active, gcc, back, hub_of)
            if int(sizes[gcc]) < k:
                verts = np.nonzero(active)[0]
                order_l[verts] = back - verts.size + 1 + np.arange(verts.size)
                back -= verts.size
                done = True
                break
        placed = order_l >= 0
        order[vmap[placed]] = order_l[placed]
        if done:
            break
        # compact: re-shard the active induced subgraph at its true size
        counts["compactions"] += 1
        count = int(active.sum())
        gip, gix = host_csr(cur)
        verts, sub_ip, sub_c = induced(gip, gix, active, count)
        vmap = vmap[verts]
        sub = CSR(write(sub_ip), write(sub_c.astype(np.int32)), None, (count, count))
        cur = ShardedCSR.from_csr(sub, mesh)
        counts["host_reads"] += 2  # from_csr's shard counts, with_halo's list length
    order = write(order.astype(np.int32))
    if stats is not None:
        _add(stats, **counts)
    return order
