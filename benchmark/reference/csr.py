"""Plain torch: CSR from a row-major COO, a stable rank, SpMV, and the
symmetric permutation of a CSR, worked out again from the inputs.

Imports nothing of the program. Everything runs in blocks of entries, so
that it fits on the card beside the program's output at the timed sizes.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch

BLOCK = 1 << 26  # entries at a time


def indptr_from_rows(row: torch.Tensor, n: int) -> torch.Tensor:
    """int64 offsets of a row-major COO's rows."""
    counts = torch.zeros((n,), dtype=torch.int64, device=row.device)
    for lo in range(0, row.numel(), BLOCK):
        counts += torch.bincount(row[lo:lo + BLOCK].long(), minlength=n)
    return torch.cat([torch.zeros((1,), dtype=torch.int64, device=row.device), torch.cumsum(counts, 0)])


def stable_rank(keys: torch.Tensor) -> torch.Tensor:
    """``rank[v]``: the position of ``v`` after a stable ascending sort of
    ``keys`` (int64)."""
    return inverse(torch.sort(keys, stable=True).indices)


def spmv(row: torch.Tensor, col: torch.Tensor, vals: torch.Tensor, x: torch.Tensor, n: int,
         dtype: torch.dtype = torch.float64) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(A @ x, |A| @ |x|)``, every product and sum taken in ``dtype``."""
    y = torch.zeros((n,), dtype=dtype, device=x.device)
    absdot = torch.zeros((n,), dtype=dtype, device=x.device)
    xd = x.to(dtype)
    for lo in range(0, row.numel(), BLOCK):
        r = row[lo:lo + BLOCK].long()
        prod = vals[lo:lo + BLOCK].to(dtype) * xd[col[lo:lo + BLOCK].long()]
        y.index_add_(0, r, prod)
        absdot.index_add_(0, r, prod.abs())
    return y, absdot


def inverse(perm: torch.Tensor) -> torch.Tensor:
    """``inv[perm[i]] = i``."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), dtype=perm.dtype, device=perm.device)
    return inv


def permuted_indptr(indptr: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Offsets of the CSR whose row ``i`` is old row ``order[i]``."""
    deg = (indptr[1:] - indptr[:-1])[order]
    return torch.cat([torch.zeros((1,), dtype=torch.int64, device=deg.device), torch.cumsum(deg, 0)])


def permuted_rows(indptr: torch.Tensor, col: torch.Tensor, vals: torch.Tensor, rank: torch.Tensor,
                  new_indptr: torch.Tensor) -> Iterator[Tuple[int, int, torch.Tensor, torch.Tensor]]:
    """The symmetric permutation ``P A P^T`` (row and column ``v`` become
    ``rank[v]``), each row's columns ascending, ties in input order, in
    blocks of new rows: ``(first entry, end, columns, values)``."""
    n = rank.numel()
    order = inverse(rank)
    a = 0
    while a < n:
        b = int(torch.searchsorted(new_indptr, new_indptr[a] + BLOCK, right=True)) - 1
        b = min(n, max(b, a + 1))
        olds = order[a:b]
        starts, deg = indptr[olds], indptr[olds + 1] - indptr[olds]
        lo, hi = int(new_indptr[a]), int(new_indptr[b])
        if hi > lo:
            seg = torch.repeat_interleave(torch.arange(b - a, device=rank.device), deg)
            first = torch.cumsum(deg, 0) - deg
            src = starts[seg] + torch.arange(hi - lo, device=rank.device) - first[seg]
            ncol = rank[col[src].long()]
            perm = torch.sort(seg * n + ncol, stable=True).indices
            yield lo, hi, ncol[perm], vals[src[perm]]
        a = b


def csr_mismatches(got_indptr: torch.Tensor, got_indices: torch.Tensor, got_vals: torch.Tensor,
                   indptr: torch.Tensor, col: torch.Tensor, vals: torch.Tensor, rank: torch.Tensor) -> int:
    """Entries of the program's permuted CSR (offsets, column ids, values,
    bit for bit) that differ from ``P A P^T`` worked out here, plus the
    difference in lengths."""
    new_indptr = permuted_indptr(indptr, inverse(rank))
    bad = abs(got_indptr.numel() - new_indptr.numel()) + abs(got_indices.numel() - int(new_indptr[-1]))
    m = min(got_indptr.numel(), new_indptr.numel())
    bad += int((got_indptr[:m].long() != new_indptr[:m]).sum())
    got_bits = got_vals.view(torch.int32) if got_vals.dtype == torch.float32 else got_vals
    for lo, hi, ncol, nval in permuted_rows(indptr, col, vals, rank, new_indptr):
        top = min(hi, got_indices.numel())
        if top > lo:
            bad += int((got_indices[lo:top].long() != ncol[:top - lo]).sum())
            want = nval[:top - lo].to(got_vals.dtype)
            want = want.view(torch.int32) if got_vals.dtype == torch.float32 else want
            bad += int((got_bits[lo:top] != want).sum())
    return bad
