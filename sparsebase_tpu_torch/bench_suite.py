"""Benchmark suite CLI: quality + throughput tables (BASELINE.md metrics).

Counterpart of ``sparsebase_tpu/bench_suite.py``. Usage::

    python -m sparsebase_tpu_torch.bench_suite [--device cuda|cpu] [--out BENCH.md] [--json]
        [--ash958 PATH] [--matrix NAME ...]
    python -m sparsebase_tpu_torch.bench_suite --dist [--shards D] [--device cuda|cpu] [--ash958 PATH]
        [--matrix NAME ...]

Measures, per matrix (the reference's ash958, when ``--ash958`` gives the
path of its ``examples/data/ash958.mtx``, and two synthetic graphs;
``--matrix`` picks some), on the card unless given ``--device cpu``:

* conversion throughput (COO↔CSR↔CSC round trip, nnz/s)
* reorder quality: bandwidth/profile reduction per algorithm
* partition quality: edge cut + balance vs a random baseline
* hypergraph (column-net) partition quality: connectivity − 1

``--dist`` prints the distributed table instead (:func:`run_distributed`):
the halo and ring functions of ``parallel`` on a mesh of ``--shards``
shards (default: every card) against the host algorithms.

The graphs are generated with numpy on the host from a seed, as the JAX
package generates them, and placed on the device afterwards, so both
packages score the same graphs; the random baselines are numpy draws too.
Every time waits for the work it times (:func:`experiment._sync`).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .experiment import _sync
from .io.placement import DEFAULT_DEVICE, target_device

ASH958 = "ash958(sym)"  # the reference library's example matrix; read from a path the caller gives


def _timeit(fn, *args, reps=3):
    _sync(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / reps


def _simple_graph(row, col, n, device):
    """The CSR of the simple graph on the pairs ``(row, col)`` (int64 numpy
    arrays): self-loops dropped, duplicates merged, placed on ``device``."""
    from .convert import coo_to_csr
    from .formats.coo import COO

    keep = row != col
    keys = np.unique(row[keep] * n + col[keep])
    dev = target_device(device)
    return coo_to_csr(
        COO.new(
            torch.from_numpy((keys // n).astype(np.int32)).to(dev),
            torch.from_numpy((keys % n).astype(np.int32)).to(dev),
            None,
            shape=(n, n),
        )
    )


def synthetic_graph(n, avg_deg, seed=0, device=DEFAULT_DEVICE):
    rng = np.random.default_rng(seed)
    nnz = n * avg_deg
    row = rng.integers(0, n, nnz).astype(np.int64)
    col = rng.integers(0, n, nnz).astype(np.int64)
    return _simple_graph(np.concatenate([row, col]), np.concatenate([col, row]), n, device)


def mesh_graph(side, seed=0, shortcut_frac=0.02, device=DEFAULT_DEVICE):
    """Scrambled 2D mesh (road/mesh class): a 4-neighbor lattice plus a few
    random shortcuts, with vertex ids randomly permuted — so the locality
    exists but must be *recovered* by the reorderer. On uniform random
    graphs the locality reorderers legitimately do nothing; this is the
    structured mid-size input where bandwidth/profile quality shows (RCM
    should recover O(side))."""
    n = side * side
    rng = np.random.default_rng(seed)
    i = np.arange(n, dtype=np.int64)
    right = i[(i % side) < side - 1]
    down = i[i < n - side]
    row = np.concatenate([right, down])
    col = np.concatenate([right + 1, down + side])
    m = int(shortcut_frac * n)
    row = np.concatenate([row, rng.integers(0, n, m)])
    col = np.concatenate([col, rng.integers(0, n, m)])
    # scramble labels
    perm = rng.permutation(n)
    row, col = perm[row], perm[col]
    return _simple_graph(np.concatenate([row, col]), np.concatenate([col, row]), n, device)


def ash958_graph(path=None, device=DEFAULT_DEVICE):
    """The reference's ash958 example (``path``: its
    ``examples/data/ash958.mtx``) symmetrised into a simple graph; raises
    where no path is given or the file is absent."""
    from .bases import IOBase
    from .formats.coo import COO

    if path is None:
        raise ValueError(f"{ASH958} reads the reference's examples/data/ash958.mtx: give its path "
                         "(ash958_graph(path), run(ash958=path), --ash958 PATH)")
    coo = IOBase.read_mtx_to_csr(str(path), device="cpu").convert(COO)
    # simple graph: dedup + drop self-loops (the rectangular index ranges
    # overlap, so raw symmetrization yields 6 duplicate pairs and 4 loops
    # that make multiset-vs-set comparisons ambiguous downstream)
    row = np.concatenate([coo.row.numpy(), coo.col.numpy()]).astype(np.int64)
    col = np.concatenate([coo.col.numpy(), coo.row.numpy()]).astype(np.int64)
    return _simple_graph(row, col, max(coo.shape), device)


def run_matrix(name, g):
    """The suite's scores of one CSR ``g``, on its device: ``{name: entry}``."""
    from . import native
    from .bases import ReorderBase
    from .convert import coo_to_csr, csr_to_coo, csr_to_csc
    from .ops.feature import Bandwidth, FillIn, Profile
    from .ops.partition import MetisPartition, balance_ratio, edge_cut
    from .ops.partition.hypergraph import PatohPartition, column_net_hypergraph, cutsize_connectivity
    from .ops.reorder import (
        AMDReorder,
        BOBAReorder,
        DegreeReorder,
        GrayReorder,
        MetisReorder,
        RabbitReorder,
        RCMReorder,
        SlashburnReorder,
    )

    entry = {"n": g.nrows, "nnz": g.nnz}
    # conversions
    dt = _timeit(lambda c: csr_to_csc(coo_to_csr(csr_to_coo(c))), g)
    entry["convert_roundtrip_nnz_per_s"] = round(g.nnz / dt, 1)
    # reorders: quality on host metrics
    bw0 = int(Bandwidth().get_bandwidth(g))
    pr0 = int(Profile().get_profile(g))
    entry["natural"] = {"bandwidth": bw0, "profile": pr0}
    reorders = {
        "degree": DegreeReorder(),
        "rcm": RCMReorder(),
        "gray": GrayReorder(),
        "boba": BOBAReorder(),
        "nested_dissection": MetisReorder(seed=0),
        "rabbit": RabbitReorder(),
        "slashburn": SlashburnReorder(k_size=32),
    }
    if g.nrows <= 5_000:
        # the quotient-graph minimum degree is sequential host code;
        # keep it off large suite matrices
        reorders["amd"] = AMDReorder()
    # fill metric (symbolic nnz(L)) — AMD's acceptance axis; the native
    # elimination-tree walker takes rand-20k in well under a second, so only
    # the pure-Python fallback keeps the small-matrix gate
    do_fill = g.nrows <= 5_000 or native.available()
    if do_fill:
        entry["natural"]["fill"] = int(FillIn().get_fill(g))
    entry["reorder"] = {}
    for rname, op in reorders.items():
        t0 = time.perf_counter()
        order = _sync(op.get_reorder(g))
        dt = time.perf_counter() - t0
        perm = ReorderBase.permute2d(order, g)
        entry["reorder"][rname] = {
            "seconds": round(dt, 3),
            "bandwidth": int(Bandwidth().get_bandwidth(perm)),
            "profile": int(Profile().get_profile(perm)),
        }
        if do_fill:
            entry["reorder"][rname]["fill"] = int(FillIn().get_fill(perm))
    # partition quality
    entry["partition"] = {}
    rng = np.random.default_rng(0)
    for k in (2, 8):
        part = MetisPartition(num_partitions=k, seed=0).partition(g)
        rand = rng.integers(0, k, g.nrows).astype(np.int32)
        entry["partition"][f"k{k}"] = {
            "edge_cut": edge_cut(g, part),
            "random_cut": edge_cut(g, rand),
            "balance": round(balance_ratio(part, k), 3),
        }
    if g.nrows > 50_000:
        # the exact-gain FM hypergraph refiner is host Python; its quality
        # is scored on the smaller suite matrices
        return {name: entry}
    # hypergraph (column-net) quality: connectivity-1, the PaToH objective
    ni, pins, cw = column_net_hypergraph(g)
    k = 4
    t0 = time.perf_counter()
    hp = PatohPartition(num_partitions=k).partition(g).cpu().numpy()
    wsizes = np.bincount(hp, weights=cw, minlength=k)
    entry["hypergraph_k4"] = {
        "seconds": round(time.perf_counter() - t0, 3),
        "connectivity_minus_1": int(cutsize_connectivity(ni, pins, hp, k)),
        "random": int(cutsize_connectivity(ni, pins, rng.integers(0, k, g.nrows).astype(np.int32), k)),
        # PaToH balances cell WEIGHT (= degrees), not vertex count
        "balance": round(float(wsizes.max() / (cw.sum() / k)), 3),
    }
    return {name: entry}


# the suite's synthetic matrices, each made on the device it is given
MATRICES = {
    "rand-20k": lambda device: synthetic_graph(20_000, 8, device=device),
    "mesh-90k(scrambled)": lambda device: mesh_graph(300, device=device),
}


def run(device: str = DEFAULT_DEVICE, names=None, ash958=None):
    """The suite on ``names`` (default: ash958 where ``ash958`` gives its
    path, then both of ``MATRICES``), on ``device`` (the card unless
    ``"cpu"``)."""
    if names is None:
        names = ([ASH958] if ash958 is not None else []) + list(MATRICES)
    results = {}
    for name in names:
        g = ash958_graph(ash958, device=device) if name == ASH958 else MATRICES[name](device)
        results.update(run_matrix(name, g))
    return results


def _dist_mesh(device, shards):
    """The distributed table's 1-D mesh: every card where ``shards`` is None
    (None where there are fewer than 2), else ``shards`` shards over the
    first cards, naming ``device`` again where there are fewer cards (the
    CPU: always). In a joined process group of more than one process it
    spans the processes (``multihost.global_mesh``): ``shards`` shards of
    ``device`` a process, else each process's visible cards (on the CPU,
    one shard a process)."""
    from .parallel import make_mesh, multihost

    dev = target_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if multihost._group()[0] > 1:
        if shards is not None:
            return multihost.global_mesh(devices=[dev] * shards)
        return multihost.global_mesh(devices=None if dev.type == "cuda" else [dev])
    cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    if shards is None:
        return make_mesh(cards) if cards >= 2 else None
    return make_mesh(shards) if dev.type == "cuda" and shards <= cards else make_mesh(devices=[dev] * shards)


def run_distributed(device: str = DEFAULT_DEVICE, shards=None, ash958=None, names=None):
    """Distributed reorder/partition quality against the host algorithms, on
    a mesh of ``shards`` shards (:func:`_dist_mesh`; a process, where the
    mesh spans the processes of a group, each of which then returns the
    single-process table but for its times): RCM, label propagation
    with refinement, SlashBurn's parity with the host order and, on matrices
    of at most 2,048 vertices, the ring's triangles and Jaccard weights
    against the host's. The matrices are ``names`` (default: ash958 where
    ``ash958`` gives its path, then rand-20k)."""
    mesh = _dist_mesh(device, shards)
    if mesh is None:
        return {"skipped": "needs >=2 devices (set xla_force_host_platform_device_count)"}

    from .bases import ReorderBase
    from .ops.feature import Bandwidth, Profile
    from .ops.feature.jaccard import _jaccard_host
    from .ops.feature.triangles import _undirected_count
    from .ops.reorder import RCMReorder
    from .ops.reorder.slashburn import SlashburnReorderParams, _slashburn_host
    from .parallel import ShardedCSR, dist, halo, ring

    if names is None:
        names = ([ASH958] if ash958 is not None else []) + ["rand-20k"]
    out = {"devices": mesh.size}
    for name in names:
        g = ash958_graph(ash958, device=device) if name == ASH958 else MATRICES[name](device)
        sh = ShardedCSR.from_csr(g, mesh, halo=True)
        entry = {
            "n": g.nrows,
            "nnz": g.nnz,
            "natural": {"bandwidth": int(Bandwidth().get_bandwidth(g)), "profile": int(Profile().get_profile(g))},
            "halo_comm_bytes_per_step": halo.step_comm_bytes(sh),
            "dense_psum_bytes_per_step": 4 * g.nrows * sh.n_shards,
        }

        def quality(order):
            perm = ReorderBase.permute2d(order.to(g.indptr.device), g)
            return {"bandwidth": int(Bandwidth().get_bandwidth(perm)), "profile": int(Profile().get_profile(perm))}

        t0 = time.perf_counter()
        host_order = _sync(RCMReorder().get_reorder(g))
        entry["rcm_host"] = {"seconds": round(time.perf_counter() - t0, 3), **quality(host_order)}
        t0 = time.perf_counter()
        d_order = _sync(halo.rcm_reorder(sh, mesh))
        entry["rcm_distributed"] = {"seconds": round(time.perf_counter() - t0, 3), **quality(d_order)}

        labels = halo.label_prop_partition(sh, 4, mesh, num_iters=20)
        refined = dist.refine_partition(sh, labels, 4, mesh, rounds=8)
        entry["labelprop_distributed_k4"] = {
            "edge_cut": int(dist.edge_cut(sh, labels, mesh)),
            "edge_cut_refined": int(dist.edge_cut(sh, refined, mesh)),
            "total_nnz": g.nnz,
        }

        # distributed SlashBurn: exact host-order parity (non-greedy)
        t0 = time.perf_counter()
        sb_dist = _sync(halo.slashburn_reorder(sh, mesh, k_size=32)).cpu().numpy()
        t_sb = time.perf_counter() - t0
        sb_host = _slashburn_host(g.indptr.cpu().numpy().astype(np.int64), g.indices.cpu().numpy().astype(np.int64),
                                  g.nrows, SlashburnReorderParams(k_size=32, greedy=False))
        entry["slashburn_distributed_k32"] = {
            "seconds": round(t_sb, 3),
            "exact_host_parity": bool(np.array_equal(sb_dist, sb_host)),
        }

        # the rings: exact against the host (the dense tile of 20k vertices
        # stays off the suite)
        if g.nrows <= 2048:
            tri = ring.triangle_count(sh, mesh)
            jac = ring.jaccard_flat(sh, mesh)
            entry["ring_mxu"] = {
                "triangles": tri,
                "triangles_match_host": bool(tri == _undirected_count(g)),
                "jaccard_match_host": bool(torch.allclose(jac.cpu(), _jaccard_host(g.to_host()), atol=1e-6)),
            }
        out[name] = entry
    return out


def to_markdown(results) -> str:
    lines = ["# Benchmark suite results", ""]
    for mname, e in results.items():
        lines += [f"## {mname} — n={e['n']}, nnz={e['nnz']}", ""]
        has_fill = "fill" in e["natural"]
        fill_hdr = " fill |" if has_fill else ""
        lines += [
            f"conversion round trip: {e['convert_roundtrip_nnz_per_s']:.3g} nnz/s",
            "",
            f"| reorder | seconds | bandwidth | profile |{fill_hdr}",
            "|---|---|---|---|" + ("---|" if has_fill else ""),
            f"| (natural) | — | {e['natural']['bandwidth']} | {e['natural']['profile']} |"
            + (f" {e['natural']['fill']} |" if has_fill else ""),
        ]
        for rname, r in e["reorder"].items():
            lines.append(
                f"| {rname} | {r['seconds']} | {r['bandwidth']} | {r['profile']} |"
                + (f" {r.get('fill', '—')} |" if has_fill else "")
            )
        lines += ["", "| k | edge cut | random cut | balance |", "|---|---|---|---|"]
        for kname, p in e["partition"].items():
            lines.append(
                f"| {kname[1:]} | {p['edge_cut']} | {p['random_cut']} | {p['balance']} |"
            )
        if "hypergraph_k4" in e:
            h = e["hypergraph_k4"]
            lines += [
                "",
                "| hypergraph k=4 | λ−1 | random λ−1 | balance |",
                "|---|---|---|---|",
                f"| column-net | {h['connectivity_minus_1']} | {h['random']} | {h['balance']} |",
            ]
        lines.append("")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m sparsebase_tpu_torch.bench_suite")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the suite runs (default cuda: the card)")
    ap.add_argument("--out", default=None, help="write a markdown report here")
    ap.add_argument("--json", action="store_true", help="print JSON instead")
    ap.add_argument("--ash958", default=None, metavar="PATH",
                    help=f"the reference's examples/data/ash958.mtx; {ASH958} runs only with it")
    ap.add_argument("--matrix", action="append", choices=[ASH958, *MATRICES],
                    help=f"run only this matrix (repeatable; default: {ASH958} where --ash958 is given, "
                         "and the synthetic ones)")
    ap.add_argument("--dist", action="store_true",
                    help="the distributed quality table only (a mesh of --shards shards, default every card)")
    ap.add_argument("--shards", type=int, default=None, metavar="D",
                    help="--dist: shards of the mesh, naming the device again where there are fewer cards")
    args = ap.parse_args(argv)
    if args.dist:
        print(json.dumps(run_distributed(device=args.device, shards=args.shards, ash958=args.ash958,
                                         names=args.matrix), indent=2))
        return
    results = run(device=args.device, names=args.matrix, ash958=args.ash958)
    if args.json:
        print(json.dumps(results, indent=2))
    else:
        md = to_markdown(results)
        if args.out:
            with open(args.out, "w") as f:
                f.write(md)
            print(f"wrote {args.out}")
        else:
            print(md)


if __name__ == "__main__":
    main()
