"""GAP's "kron" graph, made in blocks on the cards that hold it.

The graph of ``kronecker.py`` from the same settings: the same set of
entries (GAP's Kronecker edges from ``graph_seed``, ids permuted, each edge
stored both ways with its weight, self-loops dropped, duplicates merged to
the least weight), made so that no device ever holds the whole of it:

* every card draws the whole edge list from ``graph_seed``, chunk by chunk,
  with the generator calls of ``kronecker.make`` on a generator of its own,
  and keeps the entries whose row lies in its block of ``n / cards`` rows;
  it merges their duplicates one range of rows at a time;
* the run's seed then deals each card's entries to the cards in equal
  quarters of a random permutation of them, and each card shuffles what it
  received. Card k's block holds about a quarter of every row block's
  entries, in no order, as the k-th of four parts of a shuffled edge list
  would.

The run's seed also draws ``x``, on the first card, as ``kronecker.py``
does. On a CPU run every block lies on the CPU; on CUDA block k lies on
``cuda:k``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from benchmark.gen.kronecker import CHUNK, draw_edges

RANGES = 4  # row ranges a card merges its duplicates in


def make(cfg: Dict[str, Any], seed: int, dev: torch.device) -> Dict[str, Any]:
    """The blocks on the configuration's cards (``dev`` as often on the CPU,
    ``cuda:0..`` on CUDA): ``rows``, ``cols`` and ``vals`` (int32, int32,
    float32 lists, one tensor a card), and ``n``, ``devices`` and ``x``."""
    cards = int(cfg["cards"])
    devices = [dev] * cards if dev.type == "cpu" else [torch.device("cuda", k) for k in range(cards)]
    n, d = 1 << int(cfg["scale"]), len(devices)
    if n % d:
        raise ValueError(f"{n} rows do not split into {d} blocks")
    owned = _owned(cfg, devices)
    pieces = _deal(owned, seed, devices)
    del owned
    blocks = []
    for j, card in enumerate(devices):
        g = torch.Generator(device=card)
        g.manual_seed(_stream(seed, d + j))
        order = torch.randperm(sum(p[j][0].numel() for p in pieces), generator=g, device=card, dtype=torch.int32)
        block = []
        for f in range(3):  # one field at a time: its pieces go as its block comes
            got = torch.cat([p[j][f] for p in pieces])
            for p in pieces:
                p[j][f] = None
            block.append(got.index_select(0, order))
            del got
        blocks.append(block)
        del order
    rows, cols, vals = (list(f) for f in zip(*blocks))
    g_run = torch.Generator(device=devices[0])  # the run's: x
    g_run.manual_seed(int(seed))
    x = torch.rand((n,), generator=g_run, device=devices[0]) * 2 - 1
    return {"n": n, "devices": list(devices), "rows": rows, "cols": cols, "vals": vals, "x": x}


def _owned(cfg: Dict[str, Any], devices: List[torch.device]) -> list:
    """Each card's entries, of its block of rows, row-major with duplicates
    merged: ``(row, col, vals)`` on it. Every card draws the edges with the
    calls of ``kronecker.make``, in its order, from a generator of its own;
    the cards' steps alternate, so that one card's host reads overlap the
    others' work."""
    scale, ef = int(cfg["scale"]), int(cfg["edge_factor"])
    a, b, c = float(cfg["A"]), float(cfg["B"]), float(cfg["C"])
    wlo, whi = cfg["weights"]
    n, d = 1 << scale, len(devices)
    m = ef * n
    gens, perms = [], []
    for dev in devices:
        g = torch.Generator(device=dev)
        g.manual_seed(int(cfg["graph_seed"]))
        gens.append(g)
        perms.append(torch.randperm(n, generator=g, device=dev))
    keys = [[] for _ in devices]  # row << 33 | col << 8 | weight, of each card's rows
    for lo in range(0, m, CHUNK):
        cnt = min(CHUNK, m - lo)
        drawn = []
        for g, perm, dev in zip(gens, perms, devices):
            u, v = draw_edges(g, scale, cnt, a, b, c, dev)
            w = torch.randint(int(wlo), int(whi) + 1, (cnt,), generator=g, device=dev, dtype=torch.int64)
            drawn.append((perm[u], perm[v], w))
            del u, v
        for k, (src, dst, w) in enumerate(drawn):
            r0, r1 = k * n // d, (k + 1) * n // d
            keep = src != dst  # self-loops dropped
            for fro, to in ((src, dst), (dst, src)):
                sel = keep & (fro >= r0) & (fro < r1)
                keys[k].append((fro[sel] << 33) | (to[sel] << 8) | w[sel])
        del drawn
    del perms
    out = []
    for k, dev in enumerate(devices):
        total = sum(t.numel() for t in keys[k])
        out.append((torch.empty((total,), dtype=torch.int32, device=dev),
                    torch.empty((total,), dtype=torch.int32, device=dev),
                    torch.empty((total,), dtype=torch.float32, device=dev)))
    filled = [0] * d
    for p in range(RANGES):
        parts = []
        for k in range(d):
            lo_r, hi_r = (k * RANGES + p) * n // (d * RANGES), (k * RANGES + p + 1) * n // (d * RANGES)
            parts.append(torch.sort(torch.cat([t[((t >> 33) >= lo_r) & ((t >> 33) < hi_r)] for t in keys[k]])).values)
        for k, part in enumerate(parts):
            first = torch.ones((part.numel(),), dtype=torch.bool, device=part.device)
            first[1:] = (part[1:] >> 8) != (part[:-1] >> 8)  # duplicates merged: the least weight kept
            part = part[first]
            row, col, vals = out[k]
            lo, hi = filled[k], filled[k] + part.numel()
            row[lo:hi] = (part >> 33).to(torch.int32)
            col[lo:hi] = ((part >> 8) & (n - 1)).to(torch.int32)
            vals[lo:hi] = (part & 255).to(torch.float32)
            filled[k] = hi
        del parts
    del keys
    return [tuple(f[:nnz].clone() for f in fields) for fields, nnz in zip(out, filled)]


def _deal(owned, seed: int, devices):
    """Each card's entries dealt to the cards: ``pieces[k][j]``, card k's
    j-th quarter of a random permutation of its entries (rows, cols, vals),
    on card j."""
    d = len(devices)
    pieces = []
    for k, (dev, fields) in enumerate(zip(devices, owned)):
        g = torch.Generator(device=dev)
        g.manual_seed(_stream(seed, k))
        e = fields[0].numel()
        order = torch.randperm(e, generator=g, device=dev, dtype=torch.int32)
        pieces.append([[f.index_select(0, order[j * e // d:(j + 1) * e // d]).to(devices[j]) for f in fields]
                       for j in range(d)])
        del order
        owned[k] = None
    return pieces


def _stream(seed: int, k: int) -> int:
    """The seed of the run's k-th stream of the deal (k < 15), apart from
    the seed that draws ``x``."""
    return int(seed) * 16 + 1 + k
