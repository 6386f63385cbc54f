"""Plain torch: the DIA band of a COO, and repeated banded SpMV.

Imports nothing of the program. The band is ``data[d, i]`` = the entry at
row ``i``, column ``i + offsets[d]`` (zero where there is none), the
offsets ascending.
"""

from __future__ import annotations

from typing import Tuple

import torch

BLOCK = 1 << 26  # entries at a time


def band(row: torch.Tensor, col: torch.Tensor, vals: torch.Tensor, n: int,
         dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(offsets, data)``: the distinct ``col - row`` ascending (int64) and
    the ``(len(offsets), n)`` band, duplicates summed."""
    present = torch.zeros((2 * n + 1,), dtype=torch.bool, device=row.device)
    for lo in range(0, row.numel(), BLOCK):
        present[col[lo:lo + BLOCK].long() - row[lo:lo + BLOCK].long() + n] = True
    offsets = torch.nonzero(present).flatten() - n
    slot = torch.full((2 * n + 1,), -1, dtype=torch.int64, device=row.device)
    slot[offsets + n] = torch.arange(offsets.numel(), device=row.device)
    data = torch.zeros((offsets.numel(), n), dtype=dtype, device=row.device)
    for lo in range(0, row.numel(), BLOCK):
        r = row[lo:lo + BLOCK].long()
        d = slot[col[lo:lo + BLOCK].long() - r + n]
        data.index_put_((d, r), vals[lo:lo + BLOCK].to(dtype), accumulate=True)
    return offsets, data


def spmv(offsets: torch.Tensor, data: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y[i] = sum_d data[d, i] * x[i + offsets[d]]`` over the ``i + offsets[d]``
    inside ``x``, each product and sum in ``data``'s type, diagonal by
    diagonal in ascending order."""
    n = data.shape[1]
    y = torch.zeros((n,), dtype=data.dtype, device=data.device)
    xd = x.to(data.dtype)
    for d, off in enumerate(offsets.tolist()):
        lo, hi = max(0, -off), min(n, x.numel() - off)
        if hi > lo:
            y[lo:hi] += data[d, lo:hi] * xd[lo + off:hi + off]
    return y


def iterate(offsets: torch.Tensor, data: torch.Tensor, x: torch.Tensor, iterations: int, scale: float) -> torch.Tensor:
    """``x_{k+1} = (A x_k) / scale``, ``iterations`` times, in ``data``'s type."""
    x = x.to(data.dtype)
    for _ in range(iterations):
        x = spmv(offsets, data, x) / scale
    return x
