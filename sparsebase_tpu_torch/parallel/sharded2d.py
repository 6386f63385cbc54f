"""2-D mesh-sharded CSR: (row-block × column-block) distribution.

Counterpart of ``sparsebase_tpu/parallel/sharded2d.py``: the matrix is tiled
over a 2-D mesh, x is split by column blocks, every tile computes its
partial products (K2 on the tile's local CSR), and the row sums of each row
of tiles are combined with ``psum_scatter``, so tile (i, j) keeps R/Dc rows
of the sum and y is split over both axes.

Layout (Dr × Dc mesh, axes (x, y); R rows / C cols per tile, padded). Each
field is a tuple of Dr tuples of Dc per-tile tensors, tile (i, j) on the
mesh's device (i, j), each of the JAX array's (i, j) shape
(:meth:`Sharded2DCSR.stacked` gives the ``(Dr, Dc, ...)`` tensor):

* ``indptr``  (R+1,) int64 — per-tile local row pointers
* ``indices`` (W,) int32   — **tile-local** column ids in [0, C)
* ``vals``    (W,) or None
* ``nnz_local`` () int64

:meth:`Sharded2DCSR.from_csr` builds the tiles with array ops on the CSR's
device: a stable sort of the entries by tile (K5), then each tile's local
columns and its ``indptr`` (K3); the JAX package loops over rows on the host.

The container keeps the mesh it was built on. On a mesh that spans
processes (``multihost.global_mesh_2d``) each field holds this process's
tiles and ``None`` in a remote tile's slot: every process passes the same
CSR to :meth:`~Sharded2DCSR.from_csr` and cuts only its own tiles, and
:func:`spmv` and :func:`degrees` share each row of tiles' partial sums
among the processes that hold a tile of that row in one exchange, then
join the pieces over the group. On ``global_mesh_2d((P, S))`` with the
axes ``("x", "y")`` a row of tiles belongs to one process and only the
join crosses; with ``("y", "x")`` every row spans the processes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..context import Context, MeshContext
from ..formats.base import Format, register_format
from ..formats.csr import CSR
from ..ops.kernels.csr_spmv import csr_spmv
from ..ops.kernels.indptr import indptr_from_sorted_rows
from ..ops.kernels.radix import bits_below, radix_argsort
from .collectives import _total, gather, host_fetch, join, share
from .mesh import Mesh


def _tile_grid(mesh: Mesh, axes) -> tuple:
    """The mesh's devices and owners as ``(Dr, Dc)`` arrays in tile order:
    transposed where ``axes`` take the mesh's axes the other way round."""
    if mesh.axis_names.index(axes[0]) == 0:
        return mesh.devices, mesh.owners
    return mesh.devices.T, mesh.owners.T


@register_format
@dataclasses.dataclass(frozen=True)
class Sharded2DCSR(Format):
    """CSR tiled over a 2-D (row-axis × col-axis) device mesh."""

    indptr: tuple  # Dr × Dc × (R+1,)
    indices: tuple  # Dr × Dc × (W,) tile-local col ids
    vals: Optional[tuple]  # Dr × Dc × (W,) or None
    nnz_local: tuple  # Dr × Dc × ()
    _shape: Tuple[int, int] = (0, 0)
    _axes: Tuple[str, str] = ("x", "y")
    _mesh: Optional[Mesh] = None  # the mesh it was built on

    order = 2
    _FIELDS = ("indptr", "indices", "vals", "nnz_local")

    @property
    def shape(self) -> Tuple[int, int]:
        return self._shape

    @property
    def axes(self) -> Tuple[str, str]:
        return self._axes

    @property
    def grid(self) -> Tuple[int, int]:
        return (len(self.indptr), len(self.indptr[0]))

    @property
    def local(self) -> tuple:
        """The ``(i, j)`` of the tiles whose tensors this process holds."""
        return tuple((i, j) for i, row in enumerate(self.indptr) for j, t in enumerate(row) if t is not None)

    @property
    def owners(self):
        """Each tile's owner rank, a ``(Dr, Dc)`` array (all 0 on one process)."""
        return _tile_grid(self.mesh, self._axes)[1]

    @property
    def rows_per_tile(self) -> int:
        i, j = self.local[0]
        return int(self.indptr[i][j].shape[0]) - 1

    @property
    def width(self) -> int:
        i, j = self.local[0]
        return int(self.indices[i][j].shape[0])

    @functools.cached_property
    def nnz_counts(self) -> Tuple[Tuple[int, ...], ...]:
        """Each tile's true nnz on the host (one read, kept; the same on
        every process)."""
        flat = host_fetch([c for row in self.nnz_local for c in row], self.owners.reshape(-1).tolist())
        dc = self.grid[1]
        return tuple(tuple(flat[i * dc : (i + 1) * dc]) for i in range(self.grid[0]))

    @property
    def nnz(self) -> int:
        return int(sum(map(sum, self.nnz_counts)))

    @property
    def mesh(self) -> Mesh:
        if self._mesh is not None:
            return self._mesh
        return Mesh([[t.device for t in row] for row in self.indptr], self._axes)

    @property
    def context(self) -> Context:
        return MeshContext(self.mesh, self._axes[0])

    def stacked(self, name: str) -> Optional[torch.Tensor]:
        """The field ``name`` as one ``(Dr, Dc, ...)`` tensor on this
        process's first device (every tile, gathered over the group on a
        mesh that spans processes), or None."""
        parts = getattr(self, name)
        if parts is None:
            return None
        dr, dc = self.grid
        flat = gather([t for row in parts for t in row], self.owners.reshape(-1).tolist(), self.mesh.first_device)
        return torch.stack(flat).reshape(dr, dc, *flat[0].shape)

    def tile_csr(self, i: int, j: int) -> CSR:
        """Tile (i, j) as an ``(R, C)`` CSR on its device, without the padding."""
        if self.indptr[i][j] is None:
            raise ValueError(f"tile ({i}, {j}) lies on another process")
        cnt = self.nnz_counts[i][j]
        vals = None if self.vals is None else self.vals[i][j][:cnt]
        cols = -(-self._shape[1] // self.grid[1])
        return CSR(self.indptr[i][j], self.indices[i][j][:cnt], vals, (self.rows_per_tile, cols))

    def _tensors(self):
        return tuple(t for name in self._FIELDS if getattr(self, name) is not None
                     for row in getattr(self, name) for t in row if t is not None)

    @staticmethod
    def from_csr(csr: CSR, mesh: Mesh, axes: Tuple[str, str] = ("x", "y")) -> "Sharded2DCSR":
        """Tile a CSR over the 2-D ``mesh`` on the CSR's device (one host
        read: the tiles' entry counts, which size the padded width). On a
        mesh that spans processes every process passes the same CSR (on its
        own device), sorts it the same way and cuts only its own tiles."""
        n, m = csr.shape
        dr, dc = mesh.shape[axes[0]], mesh.shape[axes[1]]
        devices, owners = _tile_grid(mesh, axes)
        # rows per tile padded to a multiple of dc so the row sums scatter evenly
        rows = -(-n // dr)
        rows = -(-rows // dc) * dc
        cols = -(-m // dc)
        row = csr.row_of_nnz().to(torch.int64)
        col = csr.indices.to(torch.int64)
        tile = (row // max(rows, 1)) * dc + torch.clamp(col // max(cols, 1), max=dc - 1)
        # stable: each tile keeps the CSR's row-major order
        order = radix_argsort(tile, key_bits=bits_below(dr * dc)).long()
        tile_s, row_s, col_s = tile[order], row[order], col[order]
        vals_s = None if csr.vals is None else csr.vals[order]
        counts_t = torch.bincount(tile_s, minlength=dr * dc)
        counts = counts_t.tolist()
        starts = [0]
        for c in counts:
            starts.append(starts[-1] + c)
        width = max(max(counts), 1)
        lp, li, lv, cnts = ([[None] * dc for _ in range(dr)] for _ in range(4))
        for i in range(dr):
            for j in range(dc):
                if owners[i, j] != mesh.rank:
                    continue  # another process's tile
                t = i * dc + j
                lo, hi = starts[t], starts[t + 1]
                target = devices[i, j]
                lrow = (row_s[lo:hi] - i * rows).to(torch.int32)
                lp[i][j] = indptr_from_sorted_rows(lrow, rows).to(target)
                li[i][j] = F.pad((col_s[lo:hi] - j * cols).to(torch.int32), (0, width - (hi - lo))).to(target)
                if vals_s is not None:
                    lv[i][j] = F.pad(vals_s[lo:hi], (0, width - (hi - lo))).to(target)
                cnts[i][j] = counts_t[t].to(target)
        grid = lambda rows_: tuple(tuple(r) for r in rows_)  # noqa: E731
        sh = Sharded2DCSR(grid(lp), grid(li), None if vals_s is None else grid(lv), grid(cnts), (n, m), tuple(axes),
                          _mesh=mesh)
        sh.__dict__["nnz_counts"] = tuple(tuple(counts[i * dc : (i + 1) * dc]) for i in range(dr))
        return sh

    def __repr__(self) -> str:
        return (
            f"Sharded2DCSR(shape={self._shape}, grid={self.grid}, "
            f"rows/tile={self.rows_per_tile}, width={self.width})"
        )


def _check(sh: Sharded2DCSR, mesh: Mesh) -> None:
    if mesh != sh.mesh:
        raise ValueError(f"the tiles lie on {sh.mesh!r}, not on {mesh!r}")


def _row_sums(sh: Sharded2DCSR, mesh: Mesh, parts) -> torch.Tensor:
    """``parts[i][j]``: tile (i, j)'s ``(R,)`` partial row sums (None for a
    remote tile). Each row of tiles' sum, folded in tile order on a device
    of a process that holds a tile of the row (``psum_scatter``'s fold),
    then cut into Dc pieces: tile (i, j) keeps piece j, rows [i·R + j·R/Dc,
    i·R + (j+1)·R/Dc), so the flat (i, j) order is ascending global row
    order; the pieces are joined over the group on this process's first
    device."""
    dr, dc = sh.grid
    owners = sh.owners
    flat_owners = owners.reshape(-1).tolist()
    first = mesh.first_device
    readers = [set(owners[i].tolist()) for i in range(dr) for _ in range(dc)]
    every = share([None if p is None else (p,) for row in parts for p in row], flat_owners, readers, first)
    pieces = [None] * (dr * dc)
    for i in range(dr):
        mine = [j for j in range(dc) if parts[i][j] is not None]
        if not mine:
            continue
        total = _total([every[i * dc + j][0] for j in range(dc)], torch.add).tensor_split(dc)
        for j in mine:
            pieces[i * dc + j] = total[j].to(parts[i][j].device)
    return join(pieces, flat_owners, first)


def spmv(sh: Sharded2DCSR, x, mesh: Mesh):
    """y = A @ x on the 2-D mesh: x split by column blocks, K2 per tile, the
    partial sums of each row of tiles reduced and scattered over the row
    (``psum_scatter``); y joined in row order on this process's first
    device."""
    _check(sh, mesh)
    n, m = sh.shape
    dr, dc = sh.grid
    cols = -(-m // dc)
    xp = F.pad(x, (0, dc * cols - m))
    parts = [[None if t is None else csr_spmv(sh.tile_csr(i, j), xp[j * cols : (j + 1) * cols].to(t.device))
              for j, t in enumerate(row)] for i, row in enumerate(sh.indptr)]
    return _row_sums(sh, mesh, parts)[:n]


def degrees(sh: Sharded2DCSR, mesh: Mesh):
    """Per-row degree (int64): per-tile counts summed over the column axis,
    joined in row order."""
    _check(sh, mesh)
    parts = [[None if ip is None else ip[1:] - ip[:-1] for ip in row] for row in sh.indptr]
    return _row_sums(sh, mesh, parts)[: sh.shape[0]]
