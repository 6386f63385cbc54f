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
(``parallel.collectives``). The sorts run on K5 (``radix_argsort``) and
the local ``indptr`` on K3 on CUDA tensors, on their plain versions on CPU
tensors. A static width that sizes a buffer is read back to the host once,
as the JAX module reads it.

On a mesh that spans processes (``multihost.global_mesh``) the container
keeps its mesh, and each field holds this process's shards' tensors and
``None`` in a remote shard's slot. ``from_coo_sharded``,
``from_coo_blocks``, ``from_csr``, ``from_csr_balanced``, ``with_halo``,
``nnz``, ``halo_bytes_per_exchange`` and ``to_csr`` run there, every
process making the same calls: every host read of values from several
shards goes through ``collectives.host_fetch``, which gathers the remote
ones first. ``stacked`` gathers every shard, and ``to`` moves the shards
whose owner changes through the group.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..context import Context, MeshContext
from ..formats.base import Format, register_format
from ..formats.csr import CSR
from ..ops.kernels.indptr import indptr_from_sorted_rows
from ..ops.kernels.radix import bits_below, radix_argsort
from ..utils.tracing import count, span
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
        with span("sbtorch:shard:halo"):
            locs = [None if self.indices[k] is None else
                    _halo_locals(self.indices[k][: self.nnz_counts[k]], rows, d, k) for k in range(d)]
            c_o = [None if loc is None else loc[-1] for loc in locs]
            s = max(max(host_fetch([None if c is None else c.max() for c in c_o], owners)), 1)
            built = [None if loc is None else _halo_build(loc, rows, d, width, s, k) for k, loc in enumerate(locs)]
            del locs
            with span("sbtorch:halo:exchange"):
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
        """Distributed COO→CSR ingest of global ``row``, ``col`` and ``vals``,
        in any order, on one device: they are cut into d equal blocks (the
        last padded with the row n, which the route drops), block k copied
        to shard k's device, and ingested by :meth:`from_coo_blocks`. That
        device holds every entry; a matrix too large for one device is
        loaded in blocks, each on its shard's device, and handed to
        :meth:`from_coo_blocks` directly. ``route_capacity`` and ``stats``
        as there.

        On a mesh that spans processes every process passes the same global
        ``row``, ``col`` and ``vals`` (on its own device), and cuts and routes
        only its own shards' blocks."""
        devices = mesh.axis_devices(axis)
        owners, rank = mesh.axis_owners(axis), mesh.rank
        d = len(devices)
        nnz = int(row.shape[0])
        e = -(-nnz // d)  # entries per shard (the last block padded)
        row = convert_array_dtype(row, torch.int32)
        col = convert_array_dtype(col, torch.int32)

        def block(t, k, fill):
            if t is None or owners[k] != rank:
                return None
            piece = t[min(k * e, nnz) : min((k + 1) * e, nnz)]
            return F.pad(piece, (0, e - piece.shape[0]), value=fill).to(devices[k])

        # pad entries: row n (a row past the matrix, dropped after the
        # route), column 0, value 0
        return ShardedCSR.from_coo_blocks([block(row, k, shape[0]) for k in range(d)],
                                          [block(col, k, 0) for k in range(d)],
                                          None if vals is None else [block(vals, k, 0) for k in range(d)],
                                          shape, mesh, axis, route_capacity, stats)

    @staticmethod
    def from_coo_blocks(rowl, coll, vall, shape: Tuple[int, int], mesh: Mesh, axis: str = "x",
                        route_capacity: Optional[int] = None, stats: Optional[dict] = None) -> "ShardedCSR":
        """Distributed COO→CSR ingest of entries loaded in blocks: ``rowl``,
        ``coll`` and ``vall`` hold one int32 (int32, value) tensor a shard,
        on its device, of any lengths and in any order; ``vall`` is None for
        a pattern. No device holds more than its own block and shard.

        Each shard buckets its entries by owner (the row block of R =
        ceil(n / d) rows that a row falls in) with a stable sort (K5) and
        its bucket bounds (K3); the true entries travel to their owners in
        one ``all_to_all`` a field, in pieces of their true lengths; each
        owner sorts what it received by column and then, stably, by row
        (K5), builds its ``indptr`` (K3) and gathers its columns and values.
        The result equals :meth:`from_coo_sharded` of the blocks joined in
        shard order, field for field.

        An entry whose row is n or more is routed as the pad row n, as JAX's
        sentinel: it counts toward its owner's load, and is dropped. The
        sizes mirror the JAX module's static shapes: ``route_capacity`` is
        the per-(source, owner) bucket size, by default the largest load,
        ``pmax``'d, read back and rounded up to a power of two (at least
        64); a load over it raises before any entry moves. Each shard's
        columns and values are padded with 0 to the same kind of power of
        two over the largest true count, at most d times the capacity.
        Halo metadata is not built here: call :meth:`with_halo`. ``stats``,
        a dict, receives ``route_capacity``, ``compacted_width`` and
        ``host_reads`` (the capacity, unless given, and the loads). The
        counters ``shard.routed_entries`` and ``shard.crossed_entries`` add
        the true entries this process's shards routed, and those of them
        whose owner is another shard.

        On a mesh that spans processes a remote shard's blocks are
        ``None``."""
        n, m = shape
        devices = mesh.axis_devices(axis)
        d = len(devices)
        rows = -(-n // d)
        span_mesh = mesh if mesh.spans_processes else None
        owners = mesh.axis_owners(axis)
        local = [k for k in range(d) if owners[k] == mesh.rank]
        with span("sbtorch:shard:ingest"):
            with span("sbtorch:shard:route"):
                # each shard's entries in owner order, pads last in their
                # owner's bucket, and the buckets' bounds
                routed = [None if rowl[k] is None else _route_sort(rowl[k], n, rows, d) for k in range(d)]
                reads = 0
                if route_capacity:
                    cap = int(route_capacity)
                else:
                    cap = _pow2_at_least_64(max(host_fetch(
                        [None if r is None else torch.diff(r[1][::2]).max() for r in routed], owners)))
                    reads += 1
                # bounds[s][2r : 2r+2]: shard s's true entries for owner r
                # (then its pads up to bounds[s][2r+2])
                bounds = host_fetch([None if r is None else r[1] for r in routed], owners)
                reads += 1
            loads = [[b[2 * r + 2] - b[2 * r] for r in range(d)] for b in bounds]
            if max(map(max, loads)) > cap:
                raise ValueError(f"from_coo_sharded: routing bucket overflow — raise route_capacity (cap={cap})")
            sent = [[b[2 * r + 1] - b[2 * r] for r in range(d)] for b in bounds]
            counts = tuple(sum(sent[s][r] for s in range(d)) for r in range(d))
            w_c = min(_pow2_at_least_64(max(counts)), d * cap)
            with span("sbtorch:shard:exchange"):
                # one field at a time, so that a shard holds one field's
                # gathered pieces beside what it has received
                recv = [None if field is None else list(_route_exchange(field, routed, bounds, owners))
                        for field in (rowl, coll, vall)]
            del routed
            count("shard.routed_entries", sum(sum(sent[s]) for s in local))
            count("shard.crossed_entries", sum(sent[s][r] for s in local for r in range(d) if r != s))
            with span("sbtorch:shard:local"):
                built = [None if k not in local else _route_local(recv, k, rows, m, w_c) for k in range(d)]
            sh = ShardedCSR(
                tuple(None if b is None else b[0] for b in built),
                tuple(None if b is None else b[1] for b in built),
                None if vall is None else tuple(None if b is None else b[2] for b in built),
                tuple(None if b is None else torch.full((), c, dtype=torch.int64, device=dev)
                      for c, dev, b in zip(counts, devices, built)),
                (n, m),
                axis,
                _mesh=span_mesh,
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
def _route_sort(rowl, n: int, rows: int, d: int):
    """This shard's entries in owner order: ``(perm, bounds)``, ``perm`` the
    stable order (K5) of the key ``2 * owner + pad`` and ``bounds`` the
    (2d+1,) starts of the keys' runs (K3). A row of n or more is owned by
    its row block, as JAX's, and is a pad: it sorts last in its owner's
    bucket and counts toward its load, so a capacity sized from the loads
    fits it too."""
    key = torch.div(rowl, max(rows, 1), rounding_mode="floor").to(torch.int32).clamp_(max=d - 1)
    key.mul_(2).add_(rowl >= n)
    perm, skey = radix_argsort(key, key_bits=bits_below(2 * d), return_keys=True)
    return perm, indptr_from_sorted_rows(skey, 2 * d)


def _route_exchange(field, routed, bounds, owners) -> tuple:
    """One field's true entries on their owners: shard r receives, in shard
    order, each shard's entries for it, in their order in its block."""
    d = len(field)
    pieces = [None if routed[s] is None else
              [field[s].index_select(0, routed[s][0][bounds[s][2 * r] : bounds[s][2 * r + 1]]) for r in range(d)]
              for s in range(d)]
    return all_to_all(pieces, owners=owners)


def _route_local(recv: list, my: int, rows: int, m: int, width: int):
    """Sort shard ``my``'s received entries by (row, col), stably, and build
    its ``indptr``: ``(indptr, cols, vals)``, the columns and values padded
    with 0 to ``width``. ``recv`` holds the received rows, columns and
    values (None for a pattern), a list a field; shard ``my``'s are taken
    out of it, so that each is freed once used. Two sorts of 32-bit keys
    (K5), by column and then by row, give the order that one sort of the
    packed pair would, with half its scratch."""
    recv_r, recv_c, recv_v = (None if f is None else f[my] for f in recv)
    for f in recv:
        if f is not None:
            f[my] = None
    cnt = recv_r.shape[0]
    by_col = radix_argsort(recv_c, key_bits=bits_below(max(m, 1)))
    lrow = recv_r.index_select(0, by_col).sub_(my * rows)
    del recv_r
    by_row, srow = radix_argsort(lrow, key_bits=bits_below(rows), return_keys=True)
    del lrow
    ip = indptr_from_sorted_rows(srow, rows)
    del srow
    order = by_col.index_select(0, by_row)
    del by_col, by_row
    out = []
    for t in (recv_c, recv_v):
        if t is None:
            out.append(None)
            continue
        padded = t.new_zeros((width,))
        torch.index_select(t, 0, order, out=padded[:cnt])
        out.append(padded)
    return ip, out[0], out[1]


def _halo_locals(indices_l, rows: int, d: int, my: int):
    """Sort the shard's true column ids (K5; the JAX body sorts the padded
    slots too, as the largest key), mark unique-remote run heads, bucket by
    owner. Returns (sorted cols, sorted original positions, owner,
    unique-remote mask, running count of unique-remote lanes with a leading
    0, per-owner unique counts); every per-lane array but the mask is
    int32."""
    ps, cs = radix_argsort(indices_l, key_bits=31, return_keys=True)
    uniq_remote = torch.ones(cs.shape, dtype=torch.bool, device=cs.device)
    torch.ne(cs[1:], cs[:-1], out=uniq_remote[1:])  # run heads
    owner = torch.div(cs, max(rows, 1), rounding_mode="floor").clamp_(max=d - 1)
    uniq_remote &= owner != my
    # a lane's rank among the unique-remote lanes is seen[lane + 1] - 1,
    # the same along a run of duplicates
    seen = torch.cumsum(F.pad(uniq_remote, (1, 0)), 0, dtype=torch.int32)
    # per-owner counts: the owners are sorted, so each is a run (K3 gives
    # the runs' starts) and its count a difference of the running count
    bounds = indptr_from_sorted_rows(owner, d)
    c_o = (seen[bounds[1:]] - seen[bounds[:-1]]).long()
    return cs, ps, owner, uniq_remote, seen, c_o


_SCATTER = 1 << 26  # lanes a scatter's int64 positions are formed for at a time


def _halo_build(locals_, rows: int, d: int, width: int, s: int, my: int):
    """This shard's request lists, ``(d, s)`` (row o: the owner-local ids it
    reads from owner o; pad slots 0), and its ``halo_map``, given the
    padded per-pair list length ``s``."""
    cs, ps, owner, uniq_remote, seen, c_o = locals_
    group_base = (torch.cumsum(c_o, 0) - c_o).to(torch.int32)  # exclusive scan
    # extended index per sorted lane: local -> cs - my*rows, remote ->
    # rows + owner*s + its place in the owner's list (duplicates inherit
    # the run's rank)
    ext = owner * s
    ext += seen[1:]
    ext -= torch.index_select(group_base, 0, owner)
    ext += rows - 1
    ext = torch.where(owner == my, cs - my * rows, ext)
    req = torch.zeros((d * s + 1,), dtype=torch.int32, device=cs.device)
    halo_map = torch.zeros((width,), dtype=torch.int32, device=cs.device)  # padded slots: 0
    for lo in range(0, cs.shape[0], _SCATTER):
        hi = lo + _SCATTER
        dst = torch.where(uniq_remote[lo:hi], ext[lo:hi].long() - rows, d * s)  # d * s: the discard slot
        req.scatter_(0, dst, cs[lo:hi] - owner[lo:hi] * rows)
        halo_map.scatter_(0, ps[lo:hi].long(), ext[lo:hi])
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
