"""Mesh-sharded CSR: vertex-block distribution over a device mesh.

Counterpart of ``sparsebase_tpu/parallel/sharded.py``: a CSR partitioned
into contiguous row blocks of R = ceil(n / d) rows, one per shard along a
mesh axis, with the same padded shapes as the JAX container. The JAX arrays
lead with the shard dimension D and are sharded on it; here each field is a
tuple of d per-shard tensors, shard k's on the mesh's k-th device along the
axis, each of the JAX row's shape (:meth:`ShardedCSR.stacked` gives the
``(D, ...)`` tensor):

* ``indptr``  d × (R+1,) int64 — local row pointers
* ``indices`` d × (C,) int32  — **global** column ids, padded with 0
* ``vals``    d × (C,) or None
* ``nnz_local`` d × () int64  — true nnz of each shard

Halo metadata (built by :meth:`ShardedCSR.with_halo`, on the shards'
devices) lists, for every (owner → reader) shard pair, the sorted unique
remote vertices the reader touches:

* ``halo_send``   d × (D, S) int32 — [owner][reader, j]: owner-local row
  ids to ship; pad slots point at row 0
* ``halo_counts`` d × (D,) int64   — [owner][reader]: true list lengths
* ``halo_map``    d × (C,) int32   — per-entry index into the extended
  local vector ``[R local rows | D*S halo slots]``; the slot of (owner o,
  j) is ``R + o*S + j``

Each ``shard_map`` body of the JAX module is a per-shard function here,
called for each shard on its device, followed by the collective
(``parallel.collectives``). The sorts run on K5 (``sort_by_pairs``,
``radix_argsort``) and the local ``indptr`` on K3 on CUDA tensors, on their
plain versions on CPU tensors. A static width that sizes a buffer is read
back to the host once, as the JAX module reads it.

On a mesh that spans processes (``multihost.global_mesh``) the container
keeps its mesh, and each field holds this process's shards' tensors and
``None`` in a remote shard's slot. ``from_coo_sharded``, ``from_csr``,
``from_csr_balanced``, ``with_halo``, ``nnz``, ``halo_bytes_per_exchange``
and ``to_csr`` run there, every process making the same calls: every host
read of values from several shards goes through ``collectives.host_fetch``,
which gathers the remote ones first. ``stacked`` gathers every shard, and
``to`` moves the shards whose owner changes through the group.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..context import Context, MeshContext
from ..convert.kernels import sort_by_pairs
from ..formats.base import Format, register_format
from ..formats.csr import CSR
from ..ops.kernels.indptr import indptr_from_sorted_rows
from ..ops.kernels.radix import bits_below, radix_argsort
from ..utils.typing import convert_array_dtype
from .collectives import all_to_all, gather, host_fetch, share
from .mesh import Mesh

_INT32_MAX = 2**31 - 1


def _pow2_at_least_64(x: int) -> int:
    """The JAX module's static bucket widths: a power of two, at least 64."""
    return max(64, 1 << (max(x, 1) - 1).bit_length())


@register_format
@dataclasses.dataclass(frozen=True)
class ShardedCSR(Format):
    """Row-block sharded CSR over a 1-D mesh axis."""

    indptr: tuple  # d × (R+1,)
    indices: tuple  # d × (C,) global col ids
    vals: Optional[tuple]  # d × (C,) or None
    nnz_local: tuple  # d × ()
    _shape: Tuple[int, int] = (0, 0)
    _axis: str = "x"
    halo_send: Optional[tuple] = None  # d × (D, S)
    halo_counts: Optional[tuple] = None  # d × (D,)
    halo_map: Optional[tuple] = None  # d × (C,)
    _mesh: Optional[Mesh] = None  # kept only on a mesh that spans processes

    order = 2
    _FIELDS = ("indptr", "indices", "vals", "nnz_local", "halo_send", "halo_counts", "halo_map")

    @property
    def shape(self) -> Tuple[int, int]:
        return self._shape

    @functools.cached_property
    def nnz_counts(self) -> Tuple[int, ...]:
        """Each shard's true nnz on the host (one read, kept)."""
        return tuple(host_fetch(self.nnz_local, self.owners))

    @property
    def nnz(self) -> int:
        return int(sum(self.nnz_counts))

    @property
    def n_shards(self) -> int:
        return len(self.indptr)

    @property
    def local(self) -> tuple:
        """The shards whose tensors this process holds."""
        return tuple(k for k, p in enumerate(self.indptr) if p is not None)

    @property
    def owners(self) -> tuple:
        """Each shard's owner rank (all 0 on one process)."""
        return (0,) * self.n_shards if self._mesh is None else self._mesh.axis_owners(self._axis)

    @property
    def rows_per_shard(self) -> int:
        return int(self.indptr[self.local[0]].shape[0]) - 1

    @property
    def width(self) -> int:
        """C: the padded entries per shard."""
        return int(self.indices[self.local[0]].shape[0])

    @property
    def axis(self) -> str:
        return self._axis

    @property
    def devices(self) -> tuple:
        if self._mesh is not None:
            return self._mesh.axis_devices(self._axis)
        return tuple(t.device for t in self.indptr)

    @property
    def mesh(self) -> Mesh:
        """The 1-D mesh of the shards' devices."""
        return Mesh(list(self.devices), (self._axis,)) if self._mesh is None else self._mesh

    @property
    def context(self) -> Context:
        return MeshContext(self.mesh, self._axis)

    @property
    def has_halo(self) -> bool:
        return self.halo_send is not None

    @property
    def halo_width(self) -> int:
        """S: padded per-pair halo list length."""
        return 0 if self.halo_send is None else int(self.halo_send[self.local[0]].shape[1])

    @property
    def halo_bytes_per_exchange(self) -> int:
        """True payload bytes moved by one halo value exchange (4-byte
        elements), summed over all shard pairs: proportional to the
        partition boundary, not to n."""
        if self.halo_counts is None:
            return 0
        return 4 * sum(map(sum, host_fetch(self.halo_counts, self.owners)))

    def stacked(self, name: str) -> Optional[torch.Tensor]:
        """The field ``name`` as one ``(D, ...)`` tensor on this process's
        first device (the JAX container's array: every shard, gathered over
        the group on a mesh that spans processes), or None."""
        parts = getattr(self, name)
        if parts is None:
            return None
        return torch.stack(gather(parts, self.owners, self.mesh.first_device))

    def shard_csr(self, k: int) -> CSR:
        """Shard ``k``'s rows as a ``(R, m)`` CSR on its device, without the
        padding."""
        if self.indptr[k] is None:
            raise ValueError(f"shard {k} lies on another process")
        cnt = self.nnz_counts[k]
        vals = None if self.vals is None else self.vals[k][:cnt]
        return CSR(self.indptr[k], self.indices[k][:cnt], vals, (self.rows_per_shard, self._shape[1]))

    def _tensors(self):
        return tuple(t for name in self._FIELDS if getattr(self, name) is not None for t in getattr(self, name)
                     if t is not None)

    def to(self, context: Context) -> "ShardedCSR":
        """A ``MeshContext`` places shard k on the k-th device along its axis;
        a host or device context puts every shard there. Where the shards
        span processes they move through the group in one exchange: onto a
        mesh, each process ends up with its own shards of the target (a
        shard whose owner changes is sent to its new owner); onto a host or
        device context, every process gets every shard, and the result
        spans no process."""
        names = [name for name in self._FIELDS if getattr(self, name) is not None]
        d = self.n_shards
        if isinstance(context, MeshContext):
            mesh, axis = context.mesh, context.axis
            devices, owners = mesh.axis_devices(axis), mesh.axis_owners(axis)
            if len(devices) != d:
                raise ValueError(f"{d} shards for the {len(devices)} devices of {mesh!r} along {axis!r}")
            span = mesh if mesh.spans_processes else None
            rank = mesh.rank
        else:
            axis, devices, owners, span, rank = self._axis, (context.device,) * d, (0,) * d, None, 0
        # the ranks that hold shard k afterwards: its new owner on a spanning
        # mesh, every process otherwise
        everyone = set(self.owners)
        readers = [{o} if span is not None else everyone for o in owners]
        parts = [None if self.indptr[k] is None else tuple(getattr(self, name)[k] for name in names) for k in range(d)]
        every = share(parts, self.owners, readers, self.mesh.first_device)
        fields = {name: tuple(None if owners[k] != rank else every[k][f].to(devices[k]) for k in range(d))
                  for f, name in enumerate(names)}
        out = dataclasses.replace(self, _axis=axis, _mesh=span, **fields)
        out.__dict__["nnz_counts"] = self.nnz_counts  # read once, kept
        return out

    # -- construction --------------------------------------------------------
    @staticmethod
    def from_csr(csr: CSR, mesh: Mesh, axis: str = "x", halo: bool = True) -> "ShardedCSR":
        """Partition a CSR into row blocks over ``mesh``: sliced on the CSR's
        device, each shard then moved to its own (one host read: the shards'
        entry counts, which size the padded width). On a mesh that spans
        processes every process passes the same CSR (on its own device) and
        cuts only its own shards."""
        n, m = csr.shape
        devices, owners = mesh.axis_devices(axis), mesh.axis_owners(axis)
        d = len(devices)
        rows = -(-n // d)  # rows per shard (ceil)
        indptr = csr.indptr.to(torch.int64)
        indices = convert_array_dtype(csr.indices, torch.int32)
        bounds = [min(k * rows, n) for k in range(d + 1)]
        starts_t = indptr[torch.clamp(torch.arange(d + 1, device=indptr.device) * rows, max=n)]
        starts = starts_t.tolist()
        shard_nnz = [starts[k + 1] - starts[k] for k in range(d)]
        width = max(max(shard_nnz), 1)
        lp, li, lv, cnts = ([None] * d for _ in range(4))
        for k, dev in enumerate(devices):
            if owners[k] != mesh.rank:
                continue  # another process's shard
            lo, hi, base, cnt = bounds[k], bounds[k + 1], starts[k], shard_nnz[k]
            seg = indptr[lo : hi + 1] - base
            lp[k] = F.pad(seg, (0, rows - (hi - lo)), value=cnt).to(dev)
            li[k] = F.pad(indices[base : base + cnt], (0, width - cnt)).to(dev)
            if csr.vals is not None:
                lv[k] = F.pad(csr.vals[base : base + cnt], (0, width - cnt)).to(dev)
            cnts[k] = (starts_t[k + 1] - starts_t[k]).to(dev)
        sh = ShardedCSR(tuple(lp), tuple(li), None if csr.vals is None else tuple(lv), tuple(cnts), (n, m), axis,
                        _mesh=mesh if mesh.spans_processes else None)
        sh.__dict__["nnz_counts"] = tuple(shard_nnz)
        return sh.with_halo() if halo else sh

    @staticmethod
    def from_csr_balanced(csr: CSR, mesh: Mesh, axis: str = "x", halo: bool = True):
        """Partition with **nnz-balanced** row blocks: rows are first
        relabelled by a serpentine degree deal (:func:`balanced_row_order`),
        so every equal-row block carries near-equal nnz and the padded width
        no longer follows the worst shard on row-skewed graphs. The
        balancing is a layout permutation, so every sharded function runs
        unchanged on the result. On a mesh that spans processes every
        process passes the same CSR and computes the same order (K5) and
        permutation (K4) on its own copy.

        Returns ``(sharded, order)`` where ``order[old] = new`` is the
        applied relabelling (also the map back: a result ``r`` about new
        vertex ids reads ``r[order]`` in old ids)."""
        from ..bases import ReorderBase

        order = balanced_row_order(csr, mesh.shape[axis])
        permuted = ReorderBase.permute2d(order, csr)
        return ShardedCSR.from_csr(permuted, mesh, axis=axis, halo=halo), order

    def padded_width_ratio(self) -> float:
        """Padded memory overhead: d·width / true nnz (1.0 = perfectly
        nnz-balanced row blocks)."""
        return self.n_shards * self.width / max(self.nnz, 1)

    def with_halo(self) -> "ShardedCSR":
        """Compute halo metadata on the shards' devices: per shard a sort of
        the local column ids (K5), run-head dedup and owner bucketing; one
        ``pmax`` of the per-pair counts (read back: it sizes S) and one
        ``all_to_all`` of the request lists. The host builder
        (:func:`_build_halo`) is the oracle."""
        if self.has_halo:
            return self
        d, rows, width, owners = self.n_shards, self.rows_per_shard, self.width, self.owners
        locs = [None if self.indices[k] is None else _halo_locals(self.indices[k][: self.nnz_counts[k]], rows, d, k)
                for k in range(d)]
        c_o = [None if loc is None else loc[-1] for loc in locs]
        s = max(max(host_fetch([None if c is None else c.max() for c in c_o], owners)), 1)
        built = [None if loc is None else _halo_build(loc, rows, d, width, s, k) for k, loc in enumerate(locs)]
        # halo_counts[o][r] = reader r's request count to owner o
        counts = all_to_all(c_o, owners=owners)
        send = all_to_all([None if b is None else b[0] for b in built], owners=owners)
        out = dataclasses.replace(self, halo_send=send, halo_counts=counts,
                                  halo_map=tuple(None if b is None else b[1] for b in built))
        out.__dict__["nnz_counts"] = self.nnz_counts  # read once, kept
        return out

    @staticmethod
    def from_coo_sharded(
        row,
        col,
        vals,
        shape: Tuple[int, int],
        mesh: Mesh,
        axis: str = "x",
        route_capacity: Optional[int] = None,
        stats: Optional[dict] = None,
    ) -> "ShardedCSR":
        """Distributed COO→CSR ingest: the entries, in any order, are cut into
        d equal blocks (shard k takes block k on its device) and routed to
        their row-block owners with one ``all_to_all``, then sorted (K5) and
        converted locally (K3) — no single device holds the matrix.

        ``route_capacity`` is the per-(source, owner) bucket size. By default
        a counting pass sizes it: the largest per-(source, owner) load, a
        ``pmax``'d scalar read back and rounded up to a power of two (at
        least 64). A load over an explicit capacity raises. After the route
        each shard's columns are cut to the same kind of power of two over
        the largest true load. An entry whose row is n or more takes a bucket
        slot, as JAX's sentinel does, and is dropped after the route. Halo
        metadata is not built here: call :meth:`with_halo`. ``stats``, a
        dict, receives ``route_capacity``, ``compacted_width`` and
        ``host_reads``.

        On a mesh that spans processes every process passes the same global
        ``row``, ``col`` and ``vals`` (on its own device), and cuts and routes
        only its own shards' blocks."""
        n = shape[0]
        devices = mesh.axis_devices(axis)
        owners, rank = mesh.axis_owners(axis), mesh.rank
        d = len(devices)
        nnz = int(row.shape[0])
        e = -(-nnz // d)  # entries per shard (the last block padded)
        row = convert_array_dtype(row, torch.int32)
        col = convert_array_dtype(col, torch.int32)
        has_vals = vals is not None
        if not has_vals:
            vals = torch.zeros((nnz,), dtype=torch.float32, device=row.device)

        def block(t, k, fill):
            if owners[k] != rank:
                return None
            piece = t[min(k * e, nnz) : min((k + 1) * e, nnz)]
            return F.pad(piece, (0, e - piece.shape[0]), value=fill).to(devices[k])

        # pad entries: row n (a row past the matrix, dropped after the
        # route), column 0, value 0
        return ShardedCSR._from_blocks([block(row, k, n) for k in range(d)], [block(col, k, 0) for k in range(d)],
                                       [block(vals, k, 0) for k in range(d)], has_vals, shape, devices, axis,
                                       route_capacity, stats, mesh=mesh)

    @staticmethod
    def _from_blocks(rowl, coll, vall, has_vals: bool, shape, devices, axis: str, route_capacity=None,
                     stats: Optional[dict] = None, mesh: Optional[Mesh] = None) -> "ShardedCSR":
        """:meth:`from_coo_sharded` on entries already cut into the shards'
        equal blocks: ``rowl``, ``coll``, ``vall``, one int32 (int32, value)
        tensor a shard on its device. An entry whose row is n or more is
        routed as the pad row n, as JAX's sentinel: it fills a bucket slot,
        counts toward the loads and the capacity, and is dropped after the
        route. On a ``mesh`` that spans processes a remote shard's blocks
        are ``None``."""
        n, m = shape
        d = len(devices)
        rows = -(-n // d)
        span = mesh if mesh is not None and mesh.spans_processes else None
        owners = (0,) * d if span is None else span.axis_owners(axis)

        def each(fn, parts):
            return [None if p is None else fn(p) for p in parts]

        # the route's sort by (owner, row) comes first: its per-owner counts
        # (K3 over the sorted owners) are the JAX counting pass
        routed = [None if rowl[k] is None else _route_sort(rowl[k], coll[k], vall[k], n, rows, d) for k in range(d)]
        reads = 0
        if route_capacity:
            cap = int(route_capacity)
        else:
            cap = _pow2_at_least_64(max(host_fetch(each(lambda r: torch.diff(r[4]).max(), routed), owners)))
            reads += 1
        sends = each(lambda r: _route_send(*r[:5], n, d, cap), routed)
        recv = [all_to_all(each(lambda s: s[i], sends), owners=owners) for i in range(3)]

        # one read: each source's overflow, its buckets' loads and their pad
        # rows; the pad rows sort last in their owner's bucket, so its true
        # entries are a prefix
        def head_of(r):
            load = torch.diff(r[4])
            return torch.cat([torch.clamp(load - cap, min=0).sum().reshape(1), load, r[5]])

        head = host_fetch(each(head_of, routed), owners)
        reads += 1
        if sum(h[0] for h in head) > 0:
            raise ValueError(f"from_coo_sharded: routing bucket overflow — raise route_capacity (cap={cap})")
        # sent[s][r]: the true entries from shard s to shard r
        sent = [[head[s][1 + r] - head[s][1 + d + r] for r in range(d)] for s in range(d)]
        counts = tuple(sum(sent[s][r] for s in range(d)) for r in range(d))
        w_c = min(_pow2_at_least_64(max(counts)), d * cap)
        local = []
        for r in range(d):
            if recv[0][r] is None:
                local.append((None, None, None))
                continue
            # the true prefix of each source's piece; the JAX body sorts the
            # whole d·cap buffer, pad rows last, and cuts it to w_c
            real = [torch.cat([piece[s, : sent[s][r]] for s in range(d)]) for piece in
                    (recv[0][r], recv[1][r], recv[2][r])]
            local.append(_route_local(*real, n, m, rows, r, w_c))
        sh = ShardedCSR(
            tuple(loc[0] for loc in local),
            tuple(loc[1] for loc in local),
            tuple(loc[2] for loc in local) if has_vals else None,
            tuple(None if loc[0] is None else torch.full((), c, dtype=torch.int64, device=dev)
                  for c, dev, loc in zip(counts, devices, local)),
            (n, m),
            axis,
            _mesh=span,
        )
        sh.__dict__["nnz_counts"] = counts
        if stats is not None:
            stats.update(route_capacity=cap, compacted_width=w_c, host_reads=reads)
        return sh

    def to_csr(self) -> CSR:
        """Gather back to one CSR on the first shard's device (inverse of
        :meth:`from_csr`)."""
        n, m = self._shape
        d, rows = self.n_shards, self.rows_per_shard
        first = self.mesh.first_device
        counts = self.nnz_counts

        def every(parts):
            # each shard's true entries, gathered over the group where the
            # mesh spans processes
            return gather([None if p is None else p[:c] for p, c in zip(parts, counts)], self.owners, first)

        ips, idx = gather(self.indptr, self.owners, first), every(self.indices)
        vls = None if self.vals is None else every(self.vals)
        indptr = [torch.zeros((1,), dtype=torch.int64, device=first)]
        chunks_i, chunks_v = [], []
        base = 0
        for k in range(d):
            lo, hi = k * rows, min((k + 1) * rows, n)
            if hi <= lo:
                continue  # shard entirely past n (small matrices on big meshes)
            indptr.append(ips[k][1 : hi - lo + 1] + base)
            chunks_i.append(idx[k])
            if self.vals is not None:
                chunks_v.append(vls[k])
            base += counts[k]
        indices = torch.cat(chunks_i) if chunks_i else torch.zeros((0,), dtype=torch.int32, device=first)
        vals = None
        if self.vals is not None:
            vals = torch.cat(chunks_v) if chunks_v else vls[0][:0]
        return CSR(torch.cat(indptr), indices, vals, self._shape)

    def local_row_offset(self, shard_index):
        """Global row id of each shard's first row."""
        return shard_index * self.rows_per_shard

    def __repr__(self) -> str:
        return (
            f"ShardedCSR(shape={self._shape}, shards={self.n_shards}, "
            f"rows/shard={self.rows_per_shard}, width={self.width}, "
            f"halo={'S=%d' % self.halo_width if self.has_halo else 'none'})"
        )


def balanced_row_order(csr: CSR, d: int) -> torch.Tensor:
    """Serpentine degree deal: inverse permutation ``order[old] = new``
    (int64, on the CSR's device) under which contiguous equal-row blocks of
    ``ceil(n/d)`` rows carry near-equal nnz. Rows sorted by degree
    descending (a stable K5 sort) are dealt boustrophedon (0..d-1, d-1..0,
    ...) so heavy rows spread evenly and each block receives the same row
    count; within a block, dealt order is kept (heaviest first)."""
    n = csr.nrows
    dev = csr.indptr.device
    if n == 0:
        return torch.empty((0,), dtype=torch.int64, device=dev)
    deg = csr.degrees().to(torch.int64)
    # heavy first: ascending nnz - deg, ties in row order
    by_deg = radix_argsort(csr.nnz - deg, key_bits=bits_below(csr.nnz + 1)).long()
    rows = -(-n // d)
    # The physical shard boundaries are fixed multiples of ceil(n/d), so the
    # deal hands out exactly `rows` rows to each block before the tail block
    # B = n // rows (which gets c_B = n - B*rows): rounds 0..c_B-1 over
    # blocks 0..B (the tail block takes the heaviest rounds), then rounds
    # c_B..rows-1 over blocks 0..B-1. Positions block*rows + round tile
    # 0..n-1 exactly.
    B = n // rows
    c_tail = n - B * rows
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    p1 = c_tail * (B + 1)  # entries dealt in phase 1
    in1 = idx < p1
    w = torch.where(in1, B + 1, max(B, 1))  # round width per entry
    off = torch.where(in1, idx, idx - p1)
    round_i = torch.where(in1, off // (B + 1), c_tail + off // max(B, 1))
    pos = off % w
    blocks = torch.where(round_i % 2 == 0, pos, w - 1 - pos)
    order = torch.empty((n,), dtype=torch.int64, device=dev)
    order[by_deg] = blocks * rows + round_i
    return order


# -- the per-shard passes (each JAX shard_map body, for one shard) -----------
def _route_sort(rowl, coll, vall, n: int, rows: int, d: int):
    """Sort this shard's entries by (owner, row) (K5): ``(owners, rows,
    cols, vals, bounds, pads)``, ``bounds`` the (d+1,) start of each owner's
    run (K3), ``pads`` each run's pad rows. A row of n or more is owned by
    its row block, as JAX's, and becomes the pad row n, which sorts last in
    its owner's run and counts toward its load, so a capacity sized from
    the loads fits it too."""
    owner = torch.clamp(rowl // max(rows, 1), max=d - 1).to(torch.int32)
    rowl = torch.clamp(rowl, max=n)
    owner_s, row_s, col_s, val_s = sort_by_pairs(owner, rowl, coll, vall, major_bound=d, minor_bound=n + 1)
    bounds = indptr_from_sorted_rows(owner_s, d)
    seen = torch.cumsum(F.pad(row_s == n, (1, 0)), 0)
    return owner_s, row_s, col_s, val_s, bounds, seen[bounds[1:]] - seen[bounds[:-1]]


def _route_send(owner_s, row_s, col_s, val_s, bounds, n: int, d: int, cap: int):
    """Lay the sorted entries out in d buckets of ``cap``: ``(rows, cols,
    vals)`` each ``(d, cap)``, unfilled slots a pad row (n) of column and
    value 0; entries past a bucket's capacity are not sent (the caller
    raises)."""
    dev = row_s.device
    slot = torch.arange(row_s.shape[0], dtype=torch.int64, device=dev) - bounds[owner_s.long()]
    dst = torch.where(slot < cap, owner_s.long() * cap + slot, d * cap)  # d * cap: the discard slot
    send_r = torch.full((d * cap + 1,), n, dtype=torch.int32, device=dev).scatter_(0, dst, row_s)
    send_c = torch.zeros((d * cap + 1,), dtype=torch.int32, device=dev).scatter_(0, dst, col_s)
    send_v = torch.zeros((d * cap + 1,), dtype=val_s.dtype, device=dev).scatter_(0, dst, val_s)
    return tuple(t[: d * cap].view(d, cap) for t in (send_r, send_c, send_v))


def _route_local(recv_r, recv_c, recv_v, n: int, m: int, rows: int, my: int, width: int):
    """Sort the routed true entries by (row, col) and build the local
    ``indptr``: ``(indptr, cols, vals)``, the columns and values padded
    with 0 to ``width``."""
    rr, cc, vv = sort_by_pairs(recv_r, recv_c, recv_v, major_bound=n + 1, minor_bound=max(m, 1))
    ip = indptr_from_sorted_rows(rr - my * rows, rows)
    pad = (0, width - rr.shape[0])
    return ip, F.pad(cc, pad), F.pad(vv, pad)


def _halo_locals(indices_l, rows: int, d: int, my: int):
    """Sort the shard's true column ids (K5; the JAX body sorts the padded
    slots too, as the largest key), mark unique-remote run heads, bucket by
    owner. Returns (sorted cols, sorted original positions, owner,
    unique-remote mask, per-lane remote rank, per-owner unique counts)."""
    dev = indices_l.device
    ps, cs = radix_argsort(indices_l, key_bits=31, return_keys=True)
    cs = cs.long()
    head = torch.ones_like(cs, dtype=torch.bool)
    head[1:] = cs[1:] != cs[:-1]
    owner = torch.clamp(cs // max(rows, 1), max=d - 1)
    uniq_remote = head & (owner != my)
    # rank among unique-remote lanes; constant across a duplicate run
    seen = torch.cumsum(uniq_remote, 0)
    rank = seen - 1
    # per-owner counts: the owners are sorted, so each is a run (K3 gives
    # the runs' starts) and its count a difference of the running count
    bounds = indptr_from_sorted_rows(owner.to(torch.int32), d)
    seen = torch.cat([torch.zeros((1,), dtype=seen.dtype, device=dev), seen])
    c_o = seen[bounds[1:]] - seen[bounds[:-1]]
    return cs, ps, owner, uniq_remote, rank, c_o


def _halo_build(locals_, rows: int, d: int, width: int, s: int, my: int):
    """This shard's request lists, ``(d, s)`` (row o: the owner-local ids it
    reads from owner o; pad slots 0), and its ``halo_map``, given the
    padded per-pair list length ``s``."""
    cs, ps, owner, uniq_remote, rank, c_o = locals_
    group_base = torch.cumsum(c_o, 0) - c_o  # exclusive scan
    pos_in_owner = rank - group_base[owner]
    dst = torch.where(uniq_remote, owner * s + pos_in_owner, d * s)  # d * s: the discard slot
    req = torch.zeros((d * s + 1,), dtype=torch.int32, device=cs.device)
    req.scatter_(0, dst, (cs - owner * rows).to(torch.int32))
    # extended index per sorted lane: local -> cs - my*rows, remote ->
    # rows + owner*s + pos_in_owner (duplicates inherit the run's rank)
    ext = torch.where(owner == my, cs - my * rows, rows + owner * s + pos_in_owner).to(torch.int32)
    halo_map = torch.zeros((width,), dtype=torch.int32, device=cs.device)  # padded slots: 0
    halo_map[: ps.shape[0]].scatter_(0, ps.long(), ext)
    return req[: d * s].view(d, s), halo_map


def _build_halo(li: np.ndarray, nnz_local: np.ndarray, rows: int, d: int):
    """Host pass (the oracle of :meth:`ShardedCSR.with_halo`): per-(owner,
    reader) sorted unique remote vertices.

    Returns numpy (halo_send (d,d,S), halo_counts (d,d), halo_map (d,C))."""
    width = li.shape[1]
    lists = [[np.zeros(0, np.int64)] * d for _ in range(d)]  # [owner][reader]
    counts = np.zeros((d, d), np.int32)
    for r in range(d):
        cnt = int(nnz_local[r])
        u = np.unique(li[r, :cnt].astype(np.int64))
        owner = np.minimum(u // rows, d - 1)
        for o in range(d):
            if o == r:
                continue
            lst = u[owner == o]
            lists[o][r] = lst
            counts[o, r] = len(lst)
    s = max(int(counts.max()), 1)
    halo_send = np.zeros((d, d, s), np.int32)
    for o in range(d):
        for r in range(d):
            lst = lists[o][r]
            halo_send[o, r, : len(lst)] = (lst - o * rows).astype(np.int32)
    # per-nnz extended index: local col → col - r*rows; remote → R + o*s + pos,
    # pos the column's place in its owner's sorted list
    halo_map = np.zeros((d, width), np.int32)
    for r in range(d):
        cnt = int(nnz_local[r])
        c = li[r, :cnt].astype(np.int64)
        u, inv = np.unique(c, return_inverse=True)
        owner = np.minimum(u // rows, d - 1)
        group_start = np.concatenate([[0], np.cumsum(np.bincount(owner, minlength=d))])[owner]
        pos = np.arange(len(u)) - group_start
        hm = np.where(owner == r, u - r * rows, rows + owner * s + pos)[inv]
        halo_map[r, :cnt] = hm.astype(np.int32)
    return halo_send, counts, halo_map
