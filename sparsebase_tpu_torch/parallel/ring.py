"""Ring functions over a ShardedCSR: distributed triangle counts and per-edge
Jaccard weights.

Counterpart of ``sparsebase_tpu/parallel/ring.py``. Each shard's visiting
block moves one shard down the ring a step (``collectives.ppermute`` with
``[(j, (j - 1) % d)]``, so shard i receives from shard i + 1), and after d
steps every shard has met every block. The JAX ``shard_map`` bodies are
per-shard functions here, on each shard's true entries, called in turn on
the shards' devices.

* The dense ring (:func:`triangle_count`, :func:`jaccard_weights`): each
  shard densifies its row block to a 0/1 tile ``(R, d·R)`` (a column at or
  past ``d·R`` is dropped, as JAX's ``mode="drop"`` drops it) and the
  visiting tile is a block of rows of the same matrix. A step adds
  ``tile[:, src-block] @ visiting`` into the shard's row block of A² (and,
  directed, copies the visiting block's window of Aᵀ), or writes ``tile @
  visitingᵀ`` into the src column block of A·Aᵀ. Each product entry is a
  count below 2^24, exact in float32: on a CUDA card the tiles are
  bfloat16 and the products ``torch.mm``/``torch.addmm`` with
  ``out_dtype=torch.float32`` (tensor cores, float32 accumulation), on the
  CPU float32 tiles and the same calls without it; no other route is
  taken. A shard holds its tile, the float32 ``(R, d·R)`` product and,
  directed, the ``(R, d·R)`` window of Aᵀ in the tile's dtype: on the card
  6 bytes a cell (8 directed), on the CPU 8 (12). Past
  ``MAX_DENSE_ELEMS`` cells per shard the undirected count and the weights
  go to the sparse ring, and the directed count raises.
* The sparse ring (:func:`triangle_count_sparse`,
  :func:`jaccard_weights_sparse`): the visiting block's ``(indptr,
  indices)`` rides the ring. A shard's entries are sorted by the block
  that owns their column (``min(v // R, d - 1)``; K5, and K3 for the
  segments' starts) and each segment is counted in the step where its
  owner's block visits: per entry (u, v), the distinct members of N(u)
  that are members of N(v), by a ragged expansion of the shorter list's
  ids, ``common_neighbors.PLAIN_CHUNK_SLOTS`` at a time, searched in the
  other list (sorted lists; the count is the same from either side).
  Memory per shard is O(nnz) and the chunk's temporaries.

The counts are exact: every product entry is taken to int64 and the totals
are int64 sums. Set semantics: a repeated entry of N(u) counts once and
repeats in N(v) collapse; the dense tile collapses them likewise, while the
sparse ring counts each stored entry (u, v) on its own. Triangle mode masks
an entry with u == v and the candidates u and v; the dense triangle tile
clears the global diagonal. Jaccard keeps self-loops. A column past the
rows reads the last row of the ring (``d·R - 1``), as JAX's gathers clamp.

On a mesh that spans processes (``multihost.global_mesh``) each process
builds its own shards' tiles, segments and products, the visiting block
crosses to the other process where the ring does (``ppermute`` with the
shards' owners), and the totals, the degrees and the flat weights are
gathered over the group: every process gets the single-process mesh's
count and weights bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.kernels.common_neighbors import PLAIN_CHUNK_SLOTS, lower_bound, search_rounds
from ..ops.kernels.indptr import indptr_from_sorted_rows
from ..ops.kernels.radix import bits_below, radix_argsort
from ..utils.exceptions import TypeMismatchError
from .collectives import all_gather, join, pmax, ppermute, psum
from .dist import _local_row_of, _max0, _shards
from .mesh import Mesh
from .sharded import ShardedCSR

MAX_DENSE_ELEMS = 1 << 30  # per-shard tile cells; past it the sparse ring
SUM_BLOCK_CELLS = 1 << 24  # cells of a dense product taken to int64 at once


def _ring(d: int):
    """The ring's permutation: shard i receives from shard i + 1."""
    return [(j, (j - 1) % d) for j in range(d)]


def _tile_dtype(device: torch.device) -> torch.dtype:
    if device.type == "cuda":
        return torch.bfloat16
    if device.type == "cpu":
        return torch.float32
    raise TypeMismatchError(f"ring: a shard on {device}; need the CPU or a CUDA device")


def _product(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, add: bool) -> None:
    """``out = a @ b`` (``+=`` with ``add``) into the float32 ``out``, exact
    for 0/1 tiles: on the card bfloat16 operands with float32 output."""
    dtype = {"out_dtype": torch.float32} if a.device.type == "cuda" else {}
    if add:
        torch.addmm(out, a, b, out=out, **dtype)
    else:
        torch.mm(a, b, out=out, **dtype)


def _densify(sh: ShardedCSR, k: int, np_pad: int, zero_diag: bool) -> torch.Tensor:
    """Shard ``k``'s 0/1 tile ``(R, np_pad)`` from its true entries; a
    column outside ``[0, np_pad)`` is dropped; ``zero_diag`` clears the
    global diagonal."""
    rows, cnt = sh.rows_per_shard, sh.nnz_counts[k]
    dev = sh.devices[k]
    cells = rows * np_pad
    flat = torch.zeros((cells + 1,), dtype=_tile_dtype(dev), device=dev)  # cells: the discard slot
    col = sh.indices[k][:cnt].long()
    at = _local_row_of(sh.indptr[k], cnt) * np_pad + col
    flat.index_fill_(0, torch.where((col >= 0) & (col < np_pad), at, cells), 1)
    tile = flat[:cells].view(rows, np_pad)
    if zero_diag:
        tile.diagonal(offset=k * rows).zero_()
    return tile


def _exact_sum(sq: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """Σ sq·other as a 0-d int64: each product (a count below 2^24 times 0
    or 1, exact in float32) taken to int64, ``SUM_BLOCK_CELLS`` at a time."""
    step = max(1, SUM_BLOCK_CELLS // max(sq.shape[1], 1))
    total = torch.zeros((), dtype=torch.int64, device=sq.device)
    for r0 in range(0, sq.shape[0], step):
        total += (sq[r0 : r0 + step] * other[r0 : r0 + step]).to(torch.int64).sum()
    return total


def _each(sh: ShardedCSR, fn) -> list:
    """``fn(k)`` for each of this process's shards, None in a remote slot."""
    return [fn(k) if k in sh.local else None for k in range(sh.n_shards)]


def _total_count(sh: ShardedCSR, parts: list) -> int:
    """The exact int64 sum of the shards' 0-d counts, on every process."""
    return int(psum(parts, sh.owners)[sh.local[0]])


def _triangle_ring(sh: ShardedCSR, d: int, rows: int, directed: bool) -> int:
    """Σ A²·A (undirected) or Σ A²·Aᵀ (directed) over the dense ring, A
    with its diagonal cleared (the JAX ``_triangle_runner``)."""
    np_pad = d * rows
    tiles = _each(sh, lambda k: _densify(sh, k, np_pad, True))
    sq = _each(sh, lambda k: torch.empty((rows, np_pad), dtype=torch.float32, device=tiles[k].device))
    at = _each(sh, lambda k: torch.zeros_like(tiles[k])) if directed else None
    blk = tiles
    for step in range(d):
        for i in sh.local:
            src = (i + step) % d  # the owner of the visiting block
            _product(tiles[i][:, src * rows : (src + 1) * rows], blk[i], sq[i], add=step > 0)
            if directed:
                at[i][:, src * rows : (src + 1) * rows].copy_(blk[i][:, i * rows : (i + 1) * rows].T)
        if step < d - 1:
            blk = ppermute(blk, _ring(d), sh.owners)
    del blk
    return _total_count(sh, _each(sh, lambda i: _exact_sum(sq[i], at[i] if directed else tiles[i])))


def triangle_count(sh: ShardedCSR, mesh: Mesh, directed: bool = False) -> int:
    """Distributed triangle count (reference TriangleCount semantics:
    triangle_count.cc:141-205): undirected, on a symmetric adjacency, each
    triangle once (Σ A²·A // 6); directed, each 3-cycle u→v→w→u once (Σ
    A²·Aᵀ // 3). Self-loops are ignored (the diagonal cleared). Past
    ``MAX_DENSE_ELEMS`` tile cells per shard the undirected count is
    :func:`triangle_count_sparse`'s and the directed one raises."""
    n, d, rows, width = _shards(sh, mesh)
    if rows * d * rows > MAX_DENSE_ELEMS:
        if directed:
            raise ValueError(
                "ring.triangle_count: matrix too large for the dense ring "
                "path and the sparse ring implements undirected counting "
                "only (directed 3-cycles need the Aᵀ tile)"
            )
        return triangle_count_sparse(sh, mesh)
    return _triangle_ring(sh, d, rows, bool(directed)) // (3 if directed else 6)


def _rows_cols(sh: ShardedCSR, k: int, np_pad: int):
    """Shard ``k``'s true entries' local rows and columns, the columns
    clamped to ``[0, np_pad)`` as JAX's gathers clamp them."""
    cnt = sh.nnz_counts[k]
    return _local_row_of(sh.indptr[k], cnt), sh.indices[k][:cnt].long().clamp(0, np_pad - 1)


def _jaccard(sh: ShardedCSR, d: int, rows: int, common: list) -> Tuple[torch.Tensor, ...]:
    """Per shard, the padded ``(width,)`` float32 weights ``c / max(deg u +
    deg v - c, 1)`` of its entries from their float32 counts ``common[k]``;
    the degrees are ``all_gather``'d."""
    deg = _each(sh, lambda k: (sh.indptr[k][1:] - sh.indptr[k][:-1]).to(torch.float32))
    deg_all = all_gather(deg, sh.owners)

    def weights(k):
        lrow, col = _rows_cols(sh, k, d * rows)
        union = deg[k][lrow] + deg_all[k].reshape(-1)[col] - common[k]
        jac = torch.zeros((sh.width,), dtype=torch.float32, device=sh.devices[k])
        jac[: lrow.numel()] = common[k] / torch.clamp(union, min=1.0)
        return jac

    return tuple(_each(sh, weights))


def jaccard_weights(sh: ShardedCSR, mesh: Mesh) -> Tuple[torch.Tensor, ...]:
    """Distributed per-edge Jaccard weights J(u,v) = |N(u)∩N(v)| /
    |N(u)∪N(v)| over out-neighbourhoods: one ``(width,)`` float32 tensor
    per shard, parallel to ``sh.indices`` (pad slots 0). Past
    ``MAX_DENSE_ELEMS`` tile cells per shard, :func:`jaccard_weights_sparse`'s."""
    n, d, rows, width = _shards(sh, mesh)
    if rows * d * rows > MAX_DENSE_ELEMS:
        return jaccard_weights_sparse(sh, mesh)
    np_pad = d * rows
    tiles = _each(sh, lambda k: _densify(sh, k, np_pad, False))
    # inter[k][b] = tile_k @ tile_bᵀ: column block b of shard k's rows of A·Aᵀ
    inter = _each(sh, lambda k: torch.empty((d, rows, rows), dtype=torch.float32, device=tiles[k].device))
    blk = tiles
    for step in range(d):
        for i in sh.local:
            src = (i + step) % d
            _product(tiles[i], blk[i].T, inter[i][src], add=False)
        if step < d - 1:
            blk = ppermute(blk, _ring(d), sh.owners)
    del blk, tiles

    def common(k):
        lrow, col = _rows_cols(sh, k, np_pad)
        return inter[k].reshape(-1)[(col // rows) * rows * rows + lrow * rows + col % rows]

    return _jaccard(sh, d, rows, _each(sh, common))


# -- the sparse ring ---------------------------------------------------------------
def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _owners(sh: ShardedCSR, k: int, d: int, rows: int) -> torch.Tensor:
    """The block that owns each of shard ``k``'s true entries' columns."""
    return torch.clamp(sh.indices[k][: sh.nnz_counts[k]] // max(rows, 1), max=d - 1)


def _sparse_sizes(sh: ShardedCSR, mesh: Mesh) -> Tuple[int, int]:
    """The JAX sparse ring's static sizes: the largest row degree and the
    largest count of one shard's entries owned by one block, each rounded
    up to a power of two (one host read)."""
    n, d, rows, width = _shards(sh, mesh)
    first = sh.local[0]
    wmax = pmax(_each(sh, lambda k: _max0(sh.indptr[k][1:] - sh.indptr[k][:-1])), sh.owners)[first]
    counts = _each(sh, lambda k: torch.bincount(_owners(sh, k, d, rows).long(), minlength=d).max())
    bmax = pmax(counts, sh.owners)[first]
    w, b = torch.stack([wmax, bmax.to(wmax.device)]).tolist()
    return _pow2(w), _pow2(b)


def _count_common(lists, first, cs, clen, ts, te) -> torch.Tensor:
    """Per entry, the distinct ids of its candidates ``lists[cs : cs +
    clen]`` found in its sorted target range ``lists[ts : te]`` (``first``
    marks an id unlike the one before it in its row). A ragged expansion,
    ``PLAIN_CHUNK_SLOTS`` slots at a time (and at most one entry's list more),
    with a vectorised binary search of as many rounds as the chunk's longest
    target needs; one host read a chunk."""
    m, dev = clen.numel(), clen.device
    count = torch.zeros((m,), dtype=torch.int64, device=dev)
    ends = torch.cumsum(clen, 0)
    starts = ends - clen
    _, sizes = torch.unique_consecutive(starts // PLAIN_CHUNK_SLOTS, return_counts=True)
    bounds = [0] + torch.cumsum(sizes, 0).tolist()
    last = max(lists.numel() - 1, 0)
    # positions in int32 (the lists are far shorter than 2^31), halving the
    # search's traffic
    shift, ts, te = (cs - starts).to(torch.int32), ts.to(torch.int32), te.to(torch.int32)
    for e0, e1 in zip(bounds[:-1], bounds[1:]):
        base, top, longest = torch.stack([starts[e0], ends[e1 - 1], (te[e0:e1] - ts[e0:e1]).max()]).tolist()
        if top == base:
            continue
        owner = torch.repeat_interleave(torch.arange(e0, e1, device=dev), clen[e0:e1], output_size=top - base)
        p = torch.arange(base, top, device=dev, dtype=torch.int32) + shift[owner]
        x, hi = lists[p], te[owner]
        at = lower_bound(lists, ts[owner], hi, x, int(longest).bit_length())
        found = (at < hi) & (lists[at.clamp(max=last)] == x)
        count.index_add_(0, owner, (first[p] & found).to(torch.int64))
    return count


def _member(lists, lo, hi, x) -> torch.Tensor:
    """Per entry, whether ``x`` is in the sorted range ``lists[lo : hi]``."""
    at = lower_bound(lists, lo, hi, x, search_rounds(hi - lo))
    return (at < hi) & (lists[at.clamp(max=max(lists.numel() - 1, 0))] == x)


def _sparse_common(sh: ShardedCSR, mesh: Mesh, triangles: bool) -> list:
    """Per shard, the ``(cnt,)`` int64 count of each true entry (u, v):
    |N(u) ∩ N(v)| under set semantics, over the sparse ring (the JAX
    ``_sparse_common_runner``); in triangle mode an entry with u == v counts
    0 and the members u and v are left out."""
    n, d, rows, width = _shards(sh, mesh)

    def sort(k):
        owner = _owners(sh, k, d, rows).to(torch.int32)
        order, owner_s = radix_argsort(owner, key_bits=bits_below(d), return_keys=True)
        return _local_row_of(sh.indptr[k], sh.nnz_counts[k]), order.long(), indptr_from_sorted_rows(owner_s, d)

    local = _each(sh, sort)
    # one read of this process's shards' segment starts: shard i uses only its own
    seg = dict(zip(sh.local, torch.stack([local[k][2].to(mesh.first_device) for k in sh.local]).tolist()))
    common = _each(sh, lambda k: torch.zeros((sh.nnz_counts[k],), dtype=torch.int64, device=sh.devices[k]))
    ip_v, ind_v = sh.indptr, sh.indices
    for step in range(d):
        for i in sh.local:
            src = (i + step) % d
            lo, hi = seg[i][src], seg[i][src + 1]
            if hi == lo:
                continue
            lrow, order, _ = local[i]
            e = order[lo:hi]
            ip, ipv, cnt = sh.indptr[i], ip_v[i], sh.nnz_counts[i]
            # both blocks' lists in one int32 array, the shard's ids then the
            # visiting block's; ``first``: a row's first id or one unlike the
            # id before it
            lists = torch.cat([sh.indices[i][:cnt], ind_v[i]]).to(torch.int32)
            first = torch.ones((lists.numel() + 1,), dtype=torch.bool, device=lists.device)
            first[1:-1] = lists[1:] != lists[:-1]
            first[torch.cat([ip[:-1].clamp(max=cnt), ipv[:-1] + cnt])] = True
            first = first[:-1]
            u_loc, v = lrow[e], sh.indices[i][e].long()
            v_loc = torch.clamp(v - src * rows, 0, rows - 1)
            su, eu = ip[u_loc], ip[u_loc + 1]
            sv, ev = ipv[v_loc] + cnt, ipv[v_loc + 1] + cnt
            from_u = eu - su <= ev - sv  # candidates from the shorter list
            cs, clen = torch.where(from_u, su, sv), torch.where(from_u, eu - su, ev - sv)
            ts, te = torch.where(from_u, sv, su), torch.where(from_u, ev, eu)
            u_g = i * rows + u_loc
            if triangles:
                clen = torch.where(u_g == v, 0, clen)
            got = _count_common(lists, first, cs, clen, ts, te)
            if triangles:  # less u and v where they are members of both lists
                both = lambda x: _member(lists, su, eu, x) & _member(lists, sv, ev, x)  # noqa: E731
                got -= torch.where(u_g == v, 0, both(u_g).long() + both(v).long())
            common[i][e] = got
        if step < d - 1:
            ip_v, ind_v = ppermute(ip_v, _ring(d), sh.owners), ppermute(ind_v, _ring(d), sh.owners)
    return common


def triangle_count_sparse(sh: ShardedCSR, mesh: Mesh) -> int:
    """Distributed triangle count without densification: Σ over the stored
    entries of their common neighbours other than both ends, // 6.
    Undirected semantics on a symmetric simple adjacency (each triangle
    once); self-loops are ignored and repeats within a list collapse, while
    a repeated entry counts again."""
    common = _sparse_common(sh, mesh, True)
    return _total_count(sh, _each(sh, lambda k: common[k].sum())) // 6


def jaccard_weights_sparse(sh: ShardedCSR, mesh: Mesh) -> Tuple[torch.Tensor, ...]:
    """Distributed per-edge Jaccard without densification, laid out as
    :func:`jaccard_weights`' (one ``(width,)`` float32 tensor per shard, pad
    slots 0)."""
    n, d, rows, width = _shards(sh, mesh)
    common = _sparse_common(sh, mesh, False)
    return _jaccard(sh, d, rows, _each(sh, lambda k: common[k].to(torch.float32)))


def jaccard_flat(sh: ShardedCSR, mesh: Mesh) -> torch.Tensor:
    """The Jaccard weights in the global CSR entry order: a float32 tensor on
    this process's first device, the whole of it on every process, as
    :meth:`ShardedCSR.to_csr` joins the shards (the JAX function returns
    host numpy)."""
    padded = jaccard_weights(sh, mesh)
    return join(_each(sh, lambda k: padded[k][: sh.nnz_counts[k]]), sh.owners, mesh.first_device)
