"""GAP's "kron" graph, made on the device from a seed with plain torch.

The Graph500 Kronecker generator as the GAP Benchmark Suite runs it
(Beamer, Asanović, Patterson, arXiv:1508.03619; GAP's ``generator.h``):

* ``edge_factor * 2**scale`` edges; each picks, at each of ``scale``
  levels, one quadrant of the adjacency matrix with the probabilities
  A, B, C and D = 1 - A - B - C, which sets one bit of its row and one of
  its column;
* vertex ids permuted at random (Graph500, GAP's ``PermuteIDs``);
* GAP's weighted form: each edge an integer weight in [1, 255];
* undirected: each edge stored both ways with its weight; self-loops
  dropped and duplicates merged (GAP's ``SquishCSR`` keeps, of equal
  coordinates, the least weight), so the result is symmetric.

The graph is the configuration's: like GAP, which builds it from a fixed
seed, it is drawn from ``graph_seed`` (GAP's ``kRandSeed``), in fixed
chunks of edges from one ``torch.Generator`` on the device, so every run
on a given device and torch build holds the same graph. A run's seed draws
``x``, float32 uniform in [-1, 1). (With the vertex ids drawn from the
run's seed instead, label propagation's work changed by up to 11% from
seed to seed, against 0.1% between two runs of one seed.) The COO comes
out sorted row-major with int32 ids and float32 values.

The edges are kept as int32 ids and uint8 weights, and the stored entries
are sorted one range of rows at a time (about ``PART`` entries a range), so
that set-up never holds a sort of all ``2 * edge_factor * 2**scale`` keys.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

CHUNK = 1 << 25  # edges drawn at a time
PART = 1 << 27  # stored entries sorted at a time


def draw_edges(g: torch.Generator, scale: int, count: int, a: float, b: float, c: float, dev: torch.device):
    """``count`` edges ``(u, v)`` (int64): at each level one uniform number
    picks quadrant A (u, v bits 0, 0), B (0, 1), C (1, 0) or D (1, 1)."""
    u = torch.zeros((count,), dtype=torch.int64, device=dev)
    v = torch.zeros((count,), dtype=torch.int64, device=dev)
    for level in range(scale):
        r = torch.rand((count,), generator=g, device=dev)
        u |= (r >= a + b).to(torch.int64) << level  # quadrants C and D: the lower half
        v |= (((r >= a) & (r < a + b)) | (r >= a + b + c)).to(torch.int64) << level  # B and D: the right half
    return u, v


def make(cfg: Dict[str, Any], seed: int, dev: torch.device) -> Dict[str, Any]:
    scale, ef = int(cfg["scale"]), int(cfg["edge_factor"])
    a, b, c = float(cfg["A"]), float(cfg["B"]), float(cfg["C"])
    wlo, whi = cfg["weights"]
    n = 1 << scale
    m = ef * n
    g = torch.Generator(device=dev)  # the graph's: edges, weights and vertex ids
    g.manual_seed(int(cfg["graph_seed"]))
    perm = torch.randperm(n, generator=g, device=dev)
    src = torch.empty((m,), dtype=torch.int32, device=dev)
    dst = torch.empty((m,), dtype=torch.int32, device=dev)
    wgt = torch.empty((m,), dtype=torch.uint8, device=dev)
    for lo in range(0, m, CHUNK):
        cnt = min(CHUNK, m - lo)
        u, v = draw_edges(g, scale, cnt, a, b, c, dev)
        wgt[lo:lo + cnt] = torch.randint(int(wlo), int(whi) + 1, (cnt,), generator=g, device=dev,
                                         dtype=torch.int64)
        src[lo:lo + cnt], dst[lo:lo + cnt] = perm[u], perm[v]
        del u, v
    del perm
    keep = src != dst  # self-loops dropped
    src, dst, wgt = src[keep], dst[keep], wgt[keep]
    del keep
    cap = 2 * src.numel()
    row = torch.empty((cap,), dtype=torch.int32, device=dev)
    col = torch.empty((cap,), dtype=torch.int32, device=dev)
    vals = torch.empty((cap,), dtype=torch.float32, device=dev)
    parts = max(1, cap // PART)
    nnz = 0
    for p in range(parts):
        r0, r1 = p * n // parts, (p + 1) * n // parts
        # key = row << 33 | col << 8 | weight: a row-major sort that puts the
        # least weight first among equal coordinates; each edge is stored
        # both ways, in the range of its row
        keys = []
        for fro, to in ((src, dst), (dst, src)):
            sel = (fro >= r0) & (fro < r1)
            keys.append((fro[sel].long() << 33) | (to[sel].long() << 8) | wgt[sel].long())
            del sel
        keys = torch.sort(torch.cat(keys)).values
        first = torch.ones((keys.numel(),), dtype=torch.bool, device=dev)
        first[1:] = (keys[1:] >> 8) != (keys[:-1] >> 8)  # duplicates merged: the least weight kept
        keys = keys[first]
        del first
        hi = nnz + keys.numel()
        row[nnz:hi] = (keys >> 33).to(torch.int32)
        col[nnz:hi] = ((keys >> 8) & (n - 1)).to(torch.int32)
        vals[nnz:hi] = (keys & 255).to(torch.float32)
        nnz = hi
        del keys
    del src, dst, wgt
    row = row[:nnz].clone()  # one array at a time: the buffer goes as its copy comes
    col = col[:nnz].clone()
    vals = vals[:nnz].clone()
    g_run = torch.Generator(device=dev)  # the run's: x
    g_run.manual_seed(int(seed))
    x = torch.rand((n,), generator=g_run, device=dev) * 2 - 1
    return {"n": n, "row": row, "col": col, "vals": vals, "x": x}
