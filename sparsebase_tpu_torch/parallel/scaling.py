"""Weak-scaling harness for the distributed tier.

Counterpart of ``sparsebase_tpu/parallel/scaling.py``: sharded SpMV,
distributed RCM (and the multilevel RCM on the stencil) and label
propagation at a problem size proportional to the shard count, each row
(one kind, one shard count) in a process of its own. A row places its d
shards on the visible cards, several shards on one card when there are
fewer cards than d, and records the placement (``"devices"``);
``device="cpu"`` puts them all on the CPU. The torch calls are eager, so a
row makes one warm-up call where the JAX harness compiles.

Shards that share a card share its silicon: at d shards on c < d cards the
work grows with d on c cards, and the wall-clock efficiency is a lower
bound of what d cards would give. The bytes of one halo exchange per shard
(``halo_bytes_per_device``) do not depend on the hardware: flat per shard
on the stencil (the locality a partitioned workload has), growing on the
uniform random graph (every column is a boundary).

:func:`project_link` projects the efficiencies onto a link between shards
of a given rate and latency; it has no default figures, and :func:`main`
projects only with figures it is given (``--link-gb-s``, ``--link-alpha-s``)
and records where they came from (``--link-source``).

Usage::

    python -m sparsebase_tpu_torch.parallel.scaling [--device cpu] [--counts 1,2,4] [--kinds stencil,random]
        [--base-n 4096] [--avg-deg 8] [--reps 3] [--link-gb-s G --link-alpha-s A --link-source TEXT] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

# RCM's steps where a row did not count them: ``RCM_DEPTH_PASSES`` BFS
# passes of the graph's depth and ``RCM_RANK_ITERS`` rank refinements. A
# row of this harness counts its exchanges (``rcm_steps``: the BFS levels
# of its three passes, the levels' exchange and one a refinement).
RCM_DEPTH_PASSES = 4
RCM_RANK_ITERS = 4


def _make_graph(n, avg_deg, seed=0, kind="random", device="cuda"):
    """The harness's graph as a CSR on ``device``: ``"stencil"``, each vertex
    joined to its ``avg_deg / 2`` neighbours on either side around a ring;
    else ``n * avg_deg`` uniform pairs without repeats. Values are standard
    normal float32, drawn from ``seed`` after the pairs. The draws are the
    JAX harness's (numpy); the keys are sorted and their repeats dropped on
    ``device`` (K5 on a card), where the host's ``np.unique`` took seconds
    (about 15 s for 8.4M keys on the card's host)."""
    from ..convert.kernels import coo_to_csr
    from ..formats.coo import COO
    from ..ops.kernels.radix import bits_below, radix_unique

    rng = np.random.default_rng(seed)
    if kind == "stencil":
        w = max(avg_deg // 2, 1)
        i = np.arange(n, dtype=np.int64)
        rows = np.repeat(i, 2 * w)
        offs = np.concatenate([np.arange(-w, 0), np.arange(1, w + 1)])
        keys = rows * n + (rows + np.tile(offs, n)) % n
    else:
        nnz = n * avg_deg
        row = rng.integers(0, n, nnz).astype(np.int64)
        col = rng.integers(0, n, nnz).astype(np.int64)
        keys = row * n + col
    device = torch.device(device)
    keys = radix_unique(torch.from_numpy(keys).to(device), key_bits=bits_below(n * n))
    vals = torch.from_numpy(rng.standard_normal(keys.numel()).astype(np.float32)).to(device)
    return coo_to_csr(COO.new((keys // n).to(torch.int32), (keys % n).to(torch.int32), vals, shape=(n, n)))


def placement(d: int, device: str = "cuda") -> list:
    """The devices of a row's d shards: the CPU d times, or the visible
    cards, shard k on card ``k * min(d, cards) // d`` (several shards a
    card when there are fewer cards than d)."""
    if device == "cpu":
        return [torch.device("cpu")] * d
    if not torch.cuda.is_available():
        raise RuntimeError("scaling: no CUDA card is visible; pass device='cpu' (--device cpu) for the CPU")
    cards = min(torch.cuda.device_count(), d)
    return [torch.device("cuda", k * cards // d) for k in range(d)]


def _sync(devices) -> None:
    for dev in set(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def run_one_row(kind: str, d: int, base_n: int = 4096, avg_deg: int = 8, reps: int = 3, use_halo: bool = True,
                device: str = "cuda") -> Dict:
    """One weak-scaling row (one kind, one shard count), run in its own
    process by :func:`run_weak_scaling`: the JAX row's fields, and
    ``devices`` (the shards' placement), ``rcm_steps`` (the exchanges of
    the timed RCM call), ``setup_s`` (the graph and its sharding) and
    ``row_s`` (the whole row, imports and start-up left out)."""
    from . import ShardedCSR, halo, label_prop_partition, make_mesh, rcm_reorder, spmv

    t_row = time.perf_counter()
    print(f"# weak-scaling {kind}: d={d}", flush=True)
    devices = placement(d, device)
    mesh = make_mesh(devices=devices)
    n = base_n * d  # weak scaling: n grows with the mesh
    csr = _make_graph(n, avg_deg, seed=d, kind=kind, device=devices[0])
    sh = ShardedCSR.from_csr(csr, mesh, halo=use_halo)
    x = torch.ones((n,), dtype=torch.float32, device=mesh.first_device)
    _sync(devices)
    setup_s = time.perf_counter() - t_row

    def stage(msg):
        print(f"#   {msg} ({time.perf_counter():.0f})", flush=True)

    def timed(fn, count=1):
        fn()  # warm-up: the JAX harness compiles here
        _sync(devices)
        t0 = time.perf_counter()
        for _ in range(count):
            out = fn()
        _sync(devices)
        return out, (time.perf_counter() - t0) / count

    stage("spmv")
    spmv_fn = halo.spmv if use_halo else spmv
    _, t_spmv = timed(lambda: spmv_fn(sh, x, mesh), reps)

    stage("rcm")
    st = {}
    if use_halo:
        # bounded refinement: constant work per shard count
        halo.rcm_reorder(sh, mesh, root=0, max_iters=64, refine_iters=4)
        _sync(devices)
        t0 = time.perf_counter()
        order = halo.rcm_reorder(sh, mesh, root=0, max_iters=64, refine_iters=4, stats=st)
        _sync(devices)
        t_rcm = time.perf_counter() - t0
        rcm_steps = st["levels"] + 1 + st["refine_iters"]
    else:
        order, t_rcm = timed(lambda: rcm_reorder(sh, mesh, root=0, max_iters=64))
        rcm_steps = None

    # the multilevel RCM where the diameter bound bites: the stencil (a
    # random graph's diameter is logarithmic)
    stage("rcm_ml")
    t_rcm_ml, rcm_ml_steps, bw = None, 0, {}
    if use_halo and kind == "stencil":
        (o_ml, rcm_ml_steps), t_rcm_ml = timed(lambda: halo.rcm_reorder_ml(sh, mesh, root=0, coarsen_until=base_n))
        row, col = csr.row_of_nnz().long(), csr.indices.long()
        o_ex, o_mlh = order.long().to(row.device), o_ml.long().to(row.device)
        bw = {
            "bandwidth_natural": int((row - col).abs().max()),
            "bandwidth_rcm": int((o_ex[row] - o_ex[col]).abs().max()),
            "bandwidth_rcm_ml": int((o_mlh[row] - o_mlh[col]).abs().max()),
        }

    stage("partition")
    part_fn = halo.label_prop_partition if use_halo else label_prop_partition
    k = min(4, max(d, 2))
    _, t_part = timed(lambda: part_fn(sh, k, mesh, num_iters=6))

    # BFS depth: RCM makes O(depth) exchanges, more at larger n, the weak
    # -scaling cost of an algorithm bound by the diameter
    stage("bfs_depth")
    bfs_depth = int(halo.bfs_levels(sh, 0, mesh).max()) + 1 if use_halo else 0
    stage("row done")
    comm = halo.step_comm_bytes(sh) if use_halo else 0
    return {
        "n": n,
        "nnz": csr.nnz,
        "spmv_s": t_spmv,
        "rcm_s": t_rcm,
        "partition_s": t_part,
        "halo_path": bool(use_halo),
        "halo_bytes_per_step": comm,
        "halo_bytes_per_device": comm // d,
        "dense_bytes_per_device": 4 * n,  # the dense psum's alternative
        "bfs_depth": bfs_depth,
        "rcm_ml_s": t_rcm_ml,
        "rcm_ml_steps": rcm_ml_steps,
        **bw,
        "devices": [str(dev) for dev in devices],
        "rcm_steps": rcm_steps,
        "setup_s": setup_s,
        "row_s": time.perf_counter() - t_row,
    }


def _default_counts(device: str) -> List[int]:
    avail = os.cpu_count() if device == "cpu" else torch.cuda.device_count()
    return [d for d in (1, 2, 4, 8, 16) if d <= max(avail or 1, 1)]


def run_weak_scaling(base_n: int = 4096, avg_deg: int = 8, device_counts: Optional[List[int]] = None, reps: int = 3,
                     use_halo: bool = True, kind: str = "random", device: str = "cuda",
                     link_gb_s: Optional[float] = None, link_alpha_s: Optional[float] = None,
                     timeout: Optional[float] = None) -> Dict:
    """Time sharded SpMV, distributed RCM (and the multilevel RCM on the
    stencil) and label propagation at a constant size per shard; report
    each row's efficiency against the first and the halo's bytes per shard.
    Each row runs in its own process (:func:`run_one_row`), under
    ``timeout`` seconds when given; a row that fails raises RuntimeError
    with its stderr; each row records its process's wall (``process_s``).
    With both link figures, :func:`project_link` adds the projected
    efficiencies."""
    if device_counts is None:
        device_counts = _default_counts(device)
    root = str(Path(__file__).resolve().parents[2])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([root] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    results = {}
    for d in device_counts:
        cmd = [sys.executable, "-c", "from sparsebase_tpu_torch.parallel.scaling import main; main()", "--row", kind,
               str(d), str(base_n), str(avg_deg), str(reps), "--device", device]
        t0 = time.perf_counter()
        try:
            r = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=timeout)
        except subprocess.TimeoutExpired as e:
            raise RuntimeError(f"row {kind} d={d} passed its time limit of {timeout} s:\n"
                               + (e.stderr or b"")[-3000:].decode(errors="replace")) from None
        if r.returncode != 0:
            raise RuntimeError(f"row {kind} d={d} failed:\n" + r.stderr[-3000:])
        results[d] = {**json.loads(r.stdout.splitlines()[-1]), "process_s": time.perf_counter() - t0}

    base = results[device_counts[0]]
    for d in device_counts:
        r = results[d]
        # weak-scaling efficiency: t(first row) / t(d shards) at a size proportional to d
        r["spmv_efficiency"] = round(base["spmv_s"] / max(r["spmv_s"], 1e-9), 3)
        r["rcm_efficiency"] = round(base["rcm_s"] / max(r["rcm_s"], 1e-9), 3)
        r["partition_efficiency"] = round(base["partition_s"] / max(r["partition_s"], 1e-9), 3)
        if r.get("rcm_ml_s") is not None and base.get("rcm_ml_s"):
            r["rcm_ml_efficiency"] = round(base["rcm_ml_s"] / max(r["rcm_ml_s"], 1e-9), 3)
    if link_gb_s is not None and link_alpha_s is not None:
        project_link(results, device_counts, link_gb_s, link_alpha_s)
    return results


def _rcm_steps(r: Dict) -> int:
    if r.get("rcm_steps") is not None:
        return max(r["rcm_steps"], 1)
    return max(RCM_DEPTH_PASSES * r.get("bfs_depth", 1) + RCM_RANK_ITERS, 1)


def project_link(results: Dict, device_counts: List[int], link_gb_s: float, link_alpha_s: float) -> None:
    """Attach projected weak-scaling efficiencies to a
    :func:`run_weak_scaling` table (in place), for a link of ``link_gb_s``
    GB/s and ``link_alpha_s`` seconds a step between shards on silicon of
    their own. The model: a step's compute at the constant size per shard
    is the first row's time over its steps, and each step adds
    ``halo_bytes_per_device / rate + alpha`` past one shard. Steps: SpMV 1,
    label propagation its 6 rounds, RCM its counted exchanges
    (``rcm_steps``; else ``RCM_DEPTH_PASSES * bfs_depth + RCM_RANK_ITERS``),
    the multilevel RCM its ladder's steps plus ``RCM_RANK_ITERS``."""
    base = results[device_counts[0]]
    steps_of = {
        "spmv": lambda r: 1,
        "rcm": _rcm_steps,
        "rcm_ml": lambda r: max((r.get("rcm_ml_steps") or 0) + RCM_RANK_ITERS, 1),
        "partition": lambda r: 6,
    }
    t_of = {"spmv": "spmv_s", "rcm": "rcm_s", "rcm_ml": "rcm_ml_s", "partition": "partition_s"}
    for d in device_counts:
        r = results[d]
        for kernel, steps_fn in steps_of.items():
            if t_of[kernel] not in r or r[t_of[kernel]] is None:
                continue
            steps_d = steps_fn(r)
            steps_1 = steps_fn(base)
            t_step = base[t_of[kernel]] / max(steps_1, 1)
            comm = r["halo_bytes_per_device"] / (link_gb_s * 1e9) + link_alpha_s
            t_proj = steps_d * (t_step + (comm if d > 1 else 0.0))
            t_ideal = steps_1 * t_step
            r[f"{kernel}_projected_efficiency"] = round(t_ideal / max(t_proj, 1e-12), 3)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--row"]:
        ap = argparse.ArgumentParser()
        ap.add_argument("--row", nargs=5, metavar=("KIND", "D", "BASE_N", "AVG_DEG", "REPS"))
        ap.add_argument("--device", default="cuda")
        args = ap.parse_args(argv)
        kind, d, base_n, avg_deg, reps = args.row
        print(json.dumps(run_one_row(kind, int(d), int(base_n), int(avg_deg), int(reps), device=args.device)))
        return

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the visible cards) or cpu")
    ap.add_argument("--counts", default=None, help="shard counts, e.g. 1,2,4 (default: powers of two up to the cards)")
    ap.add_argument("--kinds", default="stencil,random")
    ap.add_argument("--base-n", type=int, default=4096)
    ap.add_argument("--avg-deg", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--link-gb-s", type=float, default=None)
    ap.add_argument("--link-alpha-s", type=float, default=None)
    ap.add_argument("--link-source", default=None, help="where the link figures come from (recorded)")
    ap.add_argument("--out", default=None, help="also write the JSON to this file")
    args = ap.parse_args(argv)
    if (args.link_gb_s is None) != (args.link_alpha_s is None):
        ap.error("--link-gb-s and --link-alpha-s go together")
    counts = None if args.counts is None else [int(c) for c in args.counts.split(",")]
    cards = [] if args.device == "cpu" else [torch.cuda.get_device_name(k) for k in range(torch.cuda.device_count())]
    out = {
        "caveat": ("shards that share a device share its silicon: the work grows with d on "
                   f"{'this host, ' + str(os.cpu_count()) + ' cores' if args.device == 'cpu' else str(len(cards)) + ' card(s)'}"
                   ", so wall-clock efficiency past that many is a lower bound of what d devices of their own would "
                   "give; halo_bytes_per_device does not depend on the hardware: flat per shard on the stencil, "
                   "growing on the uniform random graph (every column is a boundary)"),
        "projection": ({"link_gb_s": args.link_gb_s, "link_alpha_s": args.link_alpha_s, "source": args.link_source,
                        "model": project_link.__doc__.split("\n\n")[0]}
                       if args.link_gb_s is not None else "none: no link figures were given"),
        "platform": args.device,
        "cards": cards,
    }
    for kind in args.kinds.split(","):
        out[kind] = run_weak_scaling(args.base_n, args.avg_deg, counts, args.reps, kind=kind, device=args.device,
                                     link_gb_s=args.link_gb_s, link_alpha_s=args.link_alpha_s)
    txt = json.dumps(out, indent=2)
    print(txt)
    if args.out:
        Path(args.out).write_text(txt)


if __name__ == "__main__":
    main()
