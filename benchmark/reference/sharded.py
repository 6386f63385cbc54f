"""Plain torch: a matrix given as blocks of COO entries, each block on its
own device, as the CSR of each row block, and repeated SpMV.

Imports nothing of the program. Row block k (rows ``[k R, (k+1) R)``, R =
ceil(n / d)) is built on device k from the entries of every block whose
row lies in it, taken in block order and, inside a block, in the block's
order, then sorted stably by (row, column): equal coordinates keep that
order. It is built one range of ``RANGE`` rows at a time, so that it fits
on a card beside the inputs and the program's output.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import torch

BLOCK = 1 << 26  # entries at a time
RANGE = 1 << 22  # rows at a time


def row_block(n: int, d: int) -> int:
    """R: the rows of a row block."""
    return -(-n // d)


def rows_csr(rows: Sequence[torch.Tensor], cols: Sequence[torch.Tensor], vals: Sequence[torch.Tensor], lo: int,
             hi: int, m: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(indptr, cols, vals)`` of rows ``[lo, hi)`` on ``device``: int64
    offsets from 0, int32 columns, the values as given."""
    got_r, got_c, got_v = [], [], []
    for r, c, v in zip(rows, cols, vals):
        sel = (r >= lo) & (r < hi)
        got_r.append(r[sel].to(device))
        got_c.append(c[sel].to(device))
        got_v.append(v[sel].to(device))
    r, c, v = torch.cat(got_r).long() - lo, torch.cat(got_c), torch.cat(got_v)
    order = torch.sort(r * max(m, 1) + c.long(), stable=True).indices
    counts = torch.bincount(r, minlength=hi - lo)
    indptr = torch.cat([torch.zeros((1,), dtype=torch.int64, device=device), torch.cumsum(counts, 0)])
    return indptr, c[order].to(torch.int32), v[order]


def ranges(n: int, d: int, k: int) -> Iterator[Tuple[int, int]]:
    """Row block k's rows below n, as ranges of at most ``RANGE`` rows."""
    rb = row_block(n, d)
    for lo in range(k * rb, min((k + 1) * rb, n), RANGE):
        yield lo, min(lo + RANGE, (k + 1) * rb, n)


def csr_mismatches(got: Dict[str, List[torch.Tensor]], rows, cols, vals, n: int, m: int) -> int:
    """Entries of the row blocks' CSRs (``got["indptr"]``, ``["cols"]``,
    ``["vals"]``, one a block, the columns and values cut to the true
    entries) that differ from the reference's: offsets, columns and value
    bits; a block of the wrong length counts every entry it lacks or adds."""
    d = len(got["indptr"])
    rb = row_block(n, d)
    bad = 0
    for k in range(d):
        ip, gc, gv = got["indptr"][k], got["cols"][k], got["vals"][k]
        dev = ip.device
        if ip.shape != (rb + 1,) or gc.shape != gv.shape or gv.dtype != torch.float32:
            bad += rb + 1 + gc.numel()
            continue
        if int(ip[-1]) != gc.numel():
            bad += abs(int(ip[-1]) - gc.numel())
        for lo, hi in ranges(n, d, k):
            w_ip, w_c, w_v = rows_csr(rows, cols, vals, lo, hi, m, dev)
            g_ip = ip[lo - k * rb:hi - k * rb + 1]
            bad += int((g_ip - g_ip[0] != w_ip).sum())
            a, b = int(g_ip[0]), int(g_ip[-1])
            c, v = gc[a:b], gv[a:b]
            if c.numel() != w_c.numel():
                bad += abs(c.numel() - w_c.numel()) + min(c.numel(), w_c.numel())
                continue
            bad += int((c != w_c).sum()) + int((v.view(torch.int32) != w_v.view(torch.int32)).sum())
    return bad


def spmv(rows, cols, vals, x: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``A x`` on ``x``'s device, every product and sum in ``dtype``: each
    block's sums on its own device, the blocks then added in order."""
    y = torch.zeros((n,), dtype=dtype, device=x.device)
    for r, c, v in zip(rows, cols, vals):
        xd = x.to(device=r.device, dtype=dtype)
        part = torch.zeros((n,), dtype=dtype, device=r.device)
        for lo in range(0, r.numel(), BLOCK):
            part.index_add_(0, r[lo:lo + BLOCK].long(), v[lo:lo + BLOCK].to(dtype) * xd[c[lo:lo + BLOCK].long()])
        y += part.to(x.device)
    return y


def iterate(rows, cols, vals, x: torch.Tensor, n: int, iterations: int, scale: float,
            dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """``x_{k+1} = (A x_k) / scale``, ``iterations`` times, in ``dtype``."""
    x = x.to(dtype)
    for _ in range(iterations):
        x = spmv(rows, cols, vals, x, n, dtype) / scale
    return x


def largest_row_norm(rows, cols, vals, n: int, home: torch.device) -> float:
    """The largest 2-norm of a row of A, in float64."""
    total = torch.zeros((n,), dtype=torch.float64, device=home)
    for r, v in zip(rows, vals):
        part = torch.zeros((n,), dtype=torch.float64, device=r.device)
        for lo in range(0, r.numel(), BLOCK):
            part.index_add_(0, r[lo:lo + BLOCK].long(), v[lo:lo + BLOCK].to(torch.float64) ** 2)
        total += part.to(home)
    return float(total.max().sqrt())


def iterate_gap(got_x: torch.Tensor, want: torch.Tensor) -> float:
    """The widest gap of ``got_x`` from ``want`` over ``want``'s largest
    magnitude (infinite where the lengths differ or ``want`` is 0 and the
    gap is not)."""
    if got_x.numel() != want.numel():
        return float("inf")
    top = float(want.abs().max())
    gap = float((got_x.to(device=want.device, dtype=torch.float64) - want).abs().max())
    if top == 0:
        return 0.0 if gap == 0 else float("inf")
    return gap / top


def control_csr(rows, cols, vals, n: int, m: int, devices, dtype: torch.dtype) -> Dict[str, List[torch.Tensor]]:
    """The reference's row blocks, block k on ``devices[k]``, their values
    rounded to ``dtype`` and back: ``{"indptr", "cols", "vals"}``."""
    d = len(devices)
    rb = row_block(n, d)
    out = {"indptr": [], "cols": [], "vals": []}
    for k, dev in enumerate(devices):
        parts = [rows_csr(rows, cols, vals, lo, hi, m, dev) for lo, hi in ranges(n, d, k)]
        ip, base = [torch.zeros((1,), dtype=torch.int64, device=dev)], 0
        for p in parts:
            ip.append(p[0][1:] + base)
            base += int(p[0][-1])
        ip = torch.cat(ip)
        out["indptr"].append(torch.cat([ip, ip[-1:].expand(rb + 1 - ip.numel())]))
        out["cols"].append(torch.cat([p[1] for p in parts]) if parts else torch.zeros((0,), dtype=torch.int32,
                                                                                      device=dev))
        out["vals"].append(torch.cat([p[2].to(dtype).to(torch.float32) for p in parts]) if parts else
                           torch.zeros((0,), dtype=torch.float32, device=dev))
    return out
