"""HPCG's matrix, made on the device with plain torch.

HPCG's ``GenerateProblem_ref.cpp``: a 27-point stencil on an
``nx * ny * nz`` grid, row ``iz * nx * ny + iy * nx + ix``, one entry for
each of the 27 points ``(ix + sx, iy + sy, iz + sz)``, ``s`` in -1..1, that
lie in the grid, taken ``sz``, then ``sy``, then ``sx`` ascending (so the
columns of a row ascend); 26 on the diagonal and -1 off it. Interior rows
hold 27 entries, boundary rows 8 to 18. The matrix does not depend on the
seed; ``x``, float32 uniform in [-1, 1), does.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

CHUNK = 1 << 22  # rows at a time


def make(cfg: Dict[str, Any], seed: int, dev: torch.device) -> Dict[str, Any]:
    nx, ny, nz = (int(cfg[k]) for k in ("nx", "ny", "nz"))
    diag, off = float(cfg["diagonal"]), float(cfg["off_diagonal"])
    n = nx * ny * nz
    nnz = (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2) if min(nx, ny, nz) > 1 else None
    s = torch.arange(-1, 2, device=dev)
    sz, sy, sx = (t.reshape(-1) for t in torch.meshgrid(s, s, s, indexing="ij"))  # sz slowest, sx fastest
    shift = sz * nx * ny + sy * nx + sx
    rows, cols = [], []
    for lo in range(0, n, CHUNK):
        r = torch.arange(lo, min(n, lo + CHUNK), device=dev)
        ix, iy, iz = r % nx, (r // nx) % ny, r // (nx * ny)
        ok = (((ix[:, None] + sx) >= 0) & ((ix[:, None] + sx) < nx) & ((iy[:, None] + sy) >= 0)
              & ((iy[:, None] + sy) < ny) & ((iz[:, None] + sz) >= 0) & ((iz[:, None] + sz) < nz))
        rows.append(r[:, None].expand(-1, 27)[ok].to(torch.int32))
        cols.append((r[:, None] + shift)[ok].to(torch.int32))
    row, col = torch.cat(rows), torch.cat(cols)
    del rows, cols
    if nnz is not None and row.numel() != nnz:
        raise RuntimeError(f"stencil27: {row.numel()} entries, HPCG's count is {nnz}")
    vals = torch.where(row == col, diag, off).to(torch.float32)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    x = torch.rand((n,), generator=g, device=dev) * 2 - 1
    return {"n": n, "row": row, "col": col, "vals": vals, "x": x}
