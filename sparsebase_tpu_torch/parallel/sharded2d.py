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
Nothing here runs on a mesh that spans processes yet: it raises
``NotImplementedError`` (ROADMAP.md, item 10i).
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
from .collectives import psum, psum_scatter
from .mesh import Mesh, single_process


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
    def rows_per_tile(self) -> int:
        return int(self.indptr[0][0].shape[0]) - 1

    @property
    def width(self) -> int:
        return int(self.indices[0][0].shape[0])

    @functools.cached_property
    def nnz_counts(self) -> Tuple[Tuple[int, ...], ...]:
        """Each tile's true nnz on the host (one read, kept)."""
        first = self.indptr[0][0].device
        flat = torch.stack([c.to(first) for row in self.nnz_local for c in row]).tolist()
        dc = self.grid[1]
        return tuple(tuple(flat[i * dc : (i + 1) * dc]) for i in range(self.grid[0]))

    @property
    def nnz(self) -> int:
        return int(sum(map(sum, self.nnz_counts)))

    @property
    def mesh(self) -> Mesh:
        return Mesh([[t.device for t in row] for row in self.indptr], self._axes)

    @property
    def context(self) -> Context:
        return MeshContext(self.mesh, self._axes[0])

    def stacked(self, name: str) -> Optional[torch.Tensor]:
        """The field ``name`` as one ``(Dr, Dc, ...)`` tensor on the first
        tile's device, or None."""
        parts = getattr(self, name)
        if parts is None:
            return None
        first = parts[0][0].device
        return torch.stack([torch.stack([t.to(first) for t in row]) for row in parts])

    def tile_csr(self, i: int, j: int) -> CSR:
        """Tile (i, j) as an ``(R, C)`` CSR on its device, without the padding."""
        cnt = self.nnz_counts[i][j]
        vals = None if self.vals is None else self.vals[i][j][:cnt]
        cols = -(-self._shape[1] // self.grid[1])
        return CSR(self.indptr[i][j], self.indices[i][j][:cnt], vals, (self.rows_per_tile, cols))

    def _tensors(self):
        return tuple(t for name in self._FIELDS if getattr(self, name) is not None
                     for row in getattr(self, name) for t in row)

    @staticmethod
    def from_csr(csr: CSR, mesh: Mesh, axes: Tuple[str, str] = ("x", "y")) -> "Sharded2DCSR":
        """Tile a CSR over the 2-D ``mesh`` on the CSR's device (one host
        read: the tiles' entry counts, which size the padded width)."""
        n, m = csr.shape
        single_process(mesh, "Sharded2DCSR.from_csr", "10i")
        dr, dc = mesh.shape[axes[0]], mesh.shape[axes[1]]
        devices = mesh.devices if mesh.axis_names.index(axes[0]) == 0 else mesh.devices.T
        # rows per tile padded to a multiple of dc so psum_scatter tiles evenly
        rows = -(-n // dr)
        rows = -(-rows // dc) * dc
        cols = -(-m // dc)
        dev = csr.indptr.device
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
        lp, li, lv, cnts = [], [], [], []
        for i in range(dr):
            lp_r, li_r, lv_r, cnt_r = [], [], [], []
            for j in range(dc):
                t = i * dc + j
                lo, hi = starts[t], starts[t + 1]
                target = devices[i, j]
                lrow = (row_s[lo:hi] - i * rows).to(torch.int32)
                lp_r.append(indptr_from_sorted_rows(lrow, rows).to(target))
                li_r.append(F.pad((col_s[lo:hi] - j * cols).to(torch.int32), (0, width - (hi - lo))).to(target))
                if vals_s is not None:
                    lv_r.append(F.pad(vals_s[lo:hi], (0, width - (hi - lo))).to(target))
                cnt_r.append(counts_t[t].to(target))
            lp.append(tuple(lp_r))
            li.append(tuple(li_r))
            lv.append(tuple(lv_r))
            cnts.append(tuple(cnt_r))
        sh = Sharded2DCSR(tuple(lp), tuple(li), None if vals_s is None else tuple(lv), tuple(cnts), (n, m),
                          tuple(axes))
        sh.__dict__["nnz_counts"] = tuple(tuple(counts[i * dc : (i + 1) * dc]) for i in range(dr))
        return sh

    def __repr__(self) -> str:
        return (
            f"Sharded2DCSR(shape={self._shape}, grid={self.grid}, "
            f"rows/tile={self.rows_per_tile}, width={self.width})"
        )


def _check(sh: Sharded2DCSR, mesh: Mesh, where: str) -> None:
    single_process(mesh, where, "10i")
    if mesh != sh.mesh:
        raise ValueError(f"the tiles lie on {sh.mesh!r}, not on {mesh!r}")


def spmv(sh: Sharded2DCSR, x, mesh: Mesh):
    """y = A @ x on the 2-D mesh: x split by column blocks, K2 per tile, the
    partial sums of each row of tiles reduced with ``psum_scatter``; y
    joined in row order on the mesh's first device."""
    _check(sh, mesh, "sharded2d.spmv")
    n, m = sh.shape
    dr, dc = sh.grid
    cols = -(-m // dc)
    xp = F.pad(x, (0, dc * cols - m))
    first = mesh.first_device
    ys = []
    for i in range(dr):
        parts = [csr_spmv(sh.tile_csr(i, j), xp[j * cols : (j + 1) * cols].to(sh.indptr[i][j].device))
                 for j in range(dc)]
        # tile (i, j) keeps rows [i*R + j*R/Dc, i*R + (j+1)*R/Dc): the flat
        # (i, j) order is ascending global row order
        ys.extend(y.to(first) for y in psum_scatter(parts))
    return torch.cat(ys)[:n]


def degrees(sh: Sharded2DCSR, mesh: Mesh):
    """Per-row degree (int64): per-tile counts ``psum``'d over the column
    axis, joined in row order."""
    _check(sh, mesh, "sharded2d.degrees")
    n = sh.shape[0]
    first = mesh.first_device
    out = [psum([ip[1:] - ip[:-1] for ip in row])[0].to(first) for row in sh.indptr]
    return torch.cat(out)[:n]
