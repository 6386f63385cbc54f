"""One process of a group that the multi-process tests start with
``multihost.launch``: it joins the group (``multihost.initialize()`` from
torch's standard variables, gloo), builds ``global_mesh(devices=[device] *
S)`` for each S of ``--shards``, and runs on it the collectives, the host
read, the distributed ingest's path (``from_coo_sharded`` →
``with_halo`` → ``halo.spmv`` → ``dist.rcm_reorder``), the functions of
:data:`FUNCTIONS`, the calls of :data:`MULTILEVEL`, the rings of
:data:`RING` and the containers' calls of :data:`CONTAINERS` (``sharded2d``
on ``global_mesh_2d((2, S))`` in both orientations) on the graphs of
:data:`GRAPHS`, then the suite's ``run_distributed`` and an experiment of
``load_sharded_csr``, ``distributed_reorder("rcm")`` and
``distributed_spmv_kernel`` on the tool graph, written by rank 0 as an MTX
file into ``--out``. It saves what it holds to ``--out/rank{R}.pt``; the
tests hold it to the single-process mesh (:func:`run_collectives`,
:func:`run_path`, :func:`run_functions`, :func:`run_multilevel`,
:func:`run_ring`, :func:`run_containers`, :func:`run_suite` and
:func:`run_experiment` on ``make_mesh`` and ``make_mesh_2d``).

    python tests/torch_multiproc_child.py --out DIR [--device cpu|cuda] [--shards 2,4] [--backend gloo|nccl]

Under NCCL each process takes the card of its rank.
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from sparsebase_tpu_torch import CSR, IOBase, bench_suite, experiment  # noqa: E402
from sparsebase_tpu_torch.context import MeshContext, context_for  # noqa: E402
from sparsebase_tpu_torch.parallel import (  # noqa: E402
    Mesh, ShardedCSR, collectives, dist, halo, multihost, ring, sharded2d,
)

TOOL_N = 999
FIELDS = ("indptr", "indices", "vals", "nnz_local", "halo_send", "halo_counts", "halo_map")


def tool_graph(n: int = TOOL_N, avg_deg: int = 8, seed: int = 42):
    """``tools/multiproc_dcn.py``'s graph: symmetric, no self-loops, unique
    pairs, row-major, float32 values."""
    rng = np.random.default_rng(seed)
    pairs = n * avg_deg // 2
    r, c = rng.integers(0, n, pairs), rng.integers(0, n, pairs)
    keep = r != c
    r, c = r[keep], c[keep]
    keys = np.unique(np.concatenate([r, c]).astype(np.int64) * n + np.concatenate([c, r]))
    row, col = (keys // n).astype(np.int32), (keys % n).astype(np.int32)
    return row, col, rng.standard_normal(len(row)).astype(np.float32), (n, n)


def wide_graph(n: int = 37, m: int = 61, nnz: int = 400, seed: int = 5):
    """More columns than rows, and a quarter of the entries on rows at or
    past n (ROADMAP.md §3, faults 3.4 and 3.5), in no order."""
    rng = np.random.default_rng(seed)
    row, col = rng.integers(0, n, nnz), rng.integers(0, m, nnz)
    past = rng.random(nnz) < 0.25
    row[past] = n + rng.integers(0, 2 * n, int(past.sum()))
    return row.astype(np.int32), col.astype(np.int32), rng.random(nnz).astype(np.float32), (n, m)


GRAPHS = {"tool": tool_graph, "wide": wide_graph}
COLLECTIVES = ("psum", "pmax", "pmin", "all_gather", "psum_scatter", "all_to_all", "all_to_all axes", "ppermute",
               "ppermute reversed", "host_fetch", "gather ragged")
# the functions that run across processes, beside the ingest's path
FUNCTIONS = tuple(f"dist.{f}" for f in ("spmv", "edge_cut", "structure_features", "label_prop_partition",
                                        "refine_partition", "reorder_heatmap")) + tuple(
    f"halo.{f}" for f in ("bfs_levels", "label_prop_partition", "connected_components", "rcm_reorder", "edge_cut",
                          "refine_partition"))
# halo's multilevel half and SlashBurn, and the containers cut from a CSR
MULTILEVEL = tuple(f"halo.{f}" for f in ("heavy_edge_matching", "coarsen", "bfs_levels_multilevel", "rcm_reorder_ml",
                                         "multilevel_partition", "slashburn_reorder")) + (
    "ShardedCSR.from_csr", "ShardedCSR.from_csr_balanced")
# each graph's (coarsen_until, SlashBurn's k_size): the tool graph's ladders
# contract many times, its SlashBurn compacts and, with a host tail,
# finishes on the host; the wide graph's as tests/test_torch_halo_multilevel.py
MULTILEVEL_ARGS = {"tool": (64, 8), "wide": (10, 2)}
PARTS = 4  # the partitions' k
HEATMAP_PARTS = 3
# the rings, and the containers' calls (``sharded2d`` on the 2-D mesh with
# its axes either way round, ``ShardedCSR.stacked`` and ``to``)
RING = tuple(f"ring.{f}" for f in ("triangle_count", "triangle_count directed", "jaccard_weights",
                                   "triangle_count_sparse", "jaccard_weights_sparse", "jaccard_flat"))
ORIENTATIONS = {"x,y": ("x", "y"), "y,x": ("y", "x")}
CONTAINERS = tuple(f"{f} {o}" for f in ("Sharded2DCSR.from_csr", "sharded2d.spmv", "sharded2d.degrees")
                   for o in ORIENTATIONS) + ("ShardedCSR.stacked", "ShardedCSR.to mesh", "ShardedCSR.to device")
TILE_FIELDS = ("indptr", "indices", "vals", "nnz_local")
SUITE_N = 500  # the suite's graph: at most 2,048 vertices, so that its ring runs


def parts_of(d: int, shape, dtype, seed: int, local) -> list:
    """Shard k's input to a collective (a tensor drawn from ``seed + k``),
    or None for a shard of another process."""
    out = []
    for k in range(d):
        a = np.random.default_rng(seed + k).standard_normal(shape) * 1000
        out.append(torch.as_tensor(a).to(dtype) if k in local else None)
    return out


def run_collectives(mesh, device) -> dict:
    """Every collective and the host read on inputs drawn per shard; each
    result is this process's shards' (remote slots None)."""
    d, owners, local = mesh.size, mesh.axis_owners("x"), mesh.local

    def on(parts):
        return [None if p is None else p.to(device) for p in parts]

    f32 = on(parts_of(d, (5,), torch.float32, 10, local))
    i32 = on(parts_of(d, (2 * d, 3), torch.int32, 20, local))
    shift = [(s, (s + 1) % d) for s in range(d - 1)]  # shard 0 receives nothing
    ragged = [None if k not in local else torch.arange(k + 1, device=device) * (k + 1) for k in range(d)]
    out = {
        "psum": collectives.psum(f32, owners),
        "pmax": collectives.pmax(f32, owners),
        "pmin": collectives.pmin(i32, owners),
        "all_gather": collectives.all_gather(f32, owners),
        "psum_scatter": collectives.psum_scatter(on(parts_of(d, (3 * d,), torch.float32, 30, local)),
                                                 owners=owners),
        "all_to_all": collectives.all_to_all(i32, owners=owners),
        "all_to_all axes": collectives.all_to_all(i32, 0, 1, owners=owners),
        "ppermute": collectives.ppermute(f32, shift, owners),
        "ppermute reversed": collectives.ppermute(i32, [(s, d - 1 - s) for s in range(d)], owners),
        "host_fetch": collectives.host_fetch(on(parts_of(d, (3,), torch.int64, 40, local)), owners),
        "gather ragged": collectives.gather(ragged, owners),
    }
    assert tuple(out) == COLLECTIVES
    return out


def run_path(mesh, graph: str, device) -> dict:
    """The distributed ingest's path on ``graph``: the container's fields
    (this process's shards), its counts and widths, y, the RCM order and
    the other replicated results, and ``to_csr``."""
    row, col, vals, shape = GRAPHS[graph]()
    x = np.random.default_rng(7).standard_normal(shape[0]).astype(np.float32)

    def put(a):
        return torch.as_tensor(a).to(device)

    stats = {}
    sh = ShardedCSR.from_coo_sharded(put(row), put(col), put(vals), shape, mesh, stats=stats).with_halo()
    back = sh.to_csr()
    out = {name: getattr(sh, name) for name in FIELDS}
    out.update(
        stats=stats, nnz_counts=sh.nnz_counts, nnz=sh.nnz, width=sh.width, halo_width=sh.halo_width,
        halo_bytes=sh.halo_bytes_per_exchange, step_comm_bytes=halo.step_comm_bytes(sh),
        y=halo.spmv(sh, put(x), mesh), order=dist.rcm_reorder(sh, mesh), levels=dist.bfs_levels(sh, 0, mesh),
        degrees=dist.degrees(sh, mesh), degree_order=dist.degree_reorder(sh, mesh),
        csr=(back.indptr, back.indices, back.vals),
    )
    return out


def block_bounds(nnz: int, d: int) -> list:
    """Cuts of ``nnz`` entries into d consecutive blocks of unequal lengths
    (the k-th about k + 1 parts in d (d + 1) / 2)."""
    total = d * (d + 1) // 2
    return [nnz * (k * (k + 1) // 2) // total for k in range(d + 1)]


def run_blocks(mesh, graph: str, device) -> dict:
    """``graph``'s entries cut into consecutive blocks of unequal lengths,
    each process passing only its own shards' blocks to
    ``from_coo_blocks``, then ``with_halo``: the container's fields (this
    process's shards), its counts and widths, and the ingest's stats."""
    row, col, vals, shape = GRAPHS[graph]()
    d, local = mesh.size, mesh.local
    cuts = block_bounds(len(row), d)

    def blocks(a):
        return [torch.as_tensor(a[cuts[k]:cuts[k + 1]]).to(device) if k in local else None for k in range(d)]

    stats = {}
    sh = ShardedCSR.from_coo_blocks(blocks(row), blocks(col), blocks(vals), shape, mesh, stats=stats).with_halo()
    out = {name: getattr(sh, name) for name in FIELDS}
    out.update(stats=stats, nnz_counts=sh.nnz_counts, width=sh.width, halo_width=sh.halo_width)
    return out


def function_inputs(shape, seed: int = 11):
    """The functions' inputs as numpy arrays: x (m,), a labelling into
    :data:`PARTS` parts (blocks, a third of the rows moved at random),
    integer vertex weights (exact float32 sums), and a row and a column
    order."""
    n, m = shape
    rng = np.random.default_rng(seed)
    labels = (np.arange(n) * PARTS // n).astype(np.int32)
    moved = rng.integers(0, n, n // 3)
    labels[moved] = rng.integers(0, PARTS, len(moved))
    return {"x": rng.standard_normal(m).astype(np.float32), "labels": labels,
            "weights": rng.integers(1, 4, n).astype(np.float32), "order_r": rng.permutation(n).astype(np.int32),
            "order_c": rng.permutation(m).astype(np.int32)}


def function_calls(sh, mesh, inputs) -> dict:
    """Each function of :data:`FUNCTIONS` on the container ``sh``, as a call
    that takes a ``stats`` dict (filled by the functions that keep stats)."""
    x, labels, weights, order_r, order_c = (inputs[k] for k in ("x", "labels", "weights", "order_r", "order_c"))
    calls = {
        "dist.spmv": lambda st: dist.spmv(sh, x, mesh),
        "dist.edge_cut": lambda st: dist.edge_cut(sh, labels, mesh),
        "dist.structure_features": lambda st: dist.structure_features(sh, mesh),
        "dist.label_prop_partition": lambda st: dist.label_prop_partition(sh, PARTS, mesh, num_iters=8),
        "dist.refine_partition": lambda st: dist.refine_partition(sh, labels, PARTS, mesh),
        "dist.reorder_heatmap": lambda st: dist.reorder_heatmap(sh, order_r, order_c, mesh, HEATMAP_PARTS),
        "halo.bfs_levels": lambda st: halo.bfs_levels(sh, 0, mesh, stats=st),
        "halo.label_prop_partition": lambda st: halo.label_prop_partition(sh, PARTS, mesh, num_iters=8,
                                                                          vertex_weights=weights),
        "halo.connected_components": lambda st: halo.connected_components(sh, mesh, stats=st),
        "halo.rcm_reorder": lambda st: halo.rcm_reorder(sh, mesh, stats=st),
        "halo.edge_cut": lambda st: halo.edge_cut(sh, labels, mesh),
        "halo.refine_partition": lambda st: halo.refine_partition(sh, labels, PARTS, mesh),
    }
    assert tuple(calls) == FUNCTIONS
    return calls


def run_functions(mesh, graph: str, device) -> dict:
    """Each function of :data:`FUNCTIONS` on ``graph``'s container:
    ``{name: (result, stats)}``, every process holding the replicated
    result."""
    row, col, vals, shape = GRAPHS[graph]()
    sh = ShardedCSR.from_coo_sharded(*(torch.as_tensor(a).to(device) for a in (row, col, vals)), shape,
                                     mesh).with_halo()
    inputs = {k: torch.as_tensor(v).to(device) for k, v in function_inputs(shape).items()}
    out = {}
    for name, fn in function_calls(sh, mesh, inputs).items():
        stats = {}
        out[name] = (fn(stats), stats)
    return out


def container(sh) -> dict:
    """A ``ShardedCSR``'s fields (this process's shards, ``None`` in a remote
    shard's slot), its counts, shape and widths."""
    out = {name: getattr(sh, name) for name in FIELDS}
    out.update(nnz_counts=sh.nnz_counts, shape=sh.shape, width=sh.width, halo_width=sh.halo_width)
    return out


def multilevel_calls(sh, csr, mesh, graph: str) -> dict:
    """Each call of :data:`MULTILEVEL` on the container ``sh`` and its CSR
    ``csr``, taking a ``stats`` dict; a container comes back as
    :func:`container`'s dict. SlashBurn runs twice, on the mesh's tiers
    alone with ``hub_order`` and with a host tail, its stats under each."""
    until, k_size = MULTILEVEL_ARGS[graph]

    def coarsen(st):
        coarse, cid = halo.coarsen(sh, halo.heavy_edge_matching(sh, mesh), mesh, return_mapping=True, stats=st)
        return container(coarse), cid

    def balanced(st):
        out, order = ShardedCSR.from_csr_balanced(csr, mesh)
        return container(out), order

    tiers = (("on the mesh", dict(hub_order=True, host_tail=0, host_tail_nnz=0)),
             ("host tail", dict(host_tail=256, host_tail_nnz=0)))
    calls = {
        "halo.heavy_edge_matching": lambda st: halo.heavy_edge_matching(sh, mesh),
        "halo.coarsen": coarsen,
        "halo.bfs_levels_multilevel": lambda st: halo.bfs_levels_multilevel(sh, 0, mesh, coarsen_until=until,
                                                                            stats=st),
        "halo.rcm_reorder_ml": lambda st: halo.rcm_reorder_ml(sh, mesh, coarsen_until=until, stats=st),
        "halo.multilevel_partition": lambda st: halo.multilevel_partition(sh, PARTS, mesh, coarsen_until=until,
                                                                          stats=st),
        "halo.slashburn_reorder": lambda st: tuple(halo.slashburn_reorder(
            sh, mesh, k_size=k_size, stats=st.setdefault(tier, {}), **kw) for tier, kw in tiers),
        "ShardedCSR.from_csr": lambda st: container(ShardedCSR.from_csr(csr, mesh)),
        "ShardedCSR.from_csr_balanced": balanced,
    }
    assert tuple(calls) == MULTILEVEL
    return calls


def run_multilevel(mesh, graph: str, device) -> dict:
    """Each call of :data:`MULTILEVEL` on ``graph``'s container: ``{name:
    (result, stats)}``, the result ``"Class: message"`` where the call
    raised (every process raises at the same host step, on the same
    gathered data)."""
    row, col, vals, shape = GRAPHS[graph]()
    sh = ShardedCSR.from_coo_sharded(*(torch.as_tensor(a).to(device) for a in (row, col, vals)), shape,
                                     mesh).with_halo()
    out = {}
    for name, fn in multilevel_calls(sh, sh.to_csr(), mesh, graph).items():
        stats = {}
        try:
            out[name] = (fn(stats), stats)
        except Exception as e:  # the tests compare what each process raised
            out[name] = (f"{type(e).__name__}: {e}", stats)
    return out


def caught(calls: dict) -> dict:
    """Each call's result, or ``"Class: message"`` where it raised (every
    process raises at the same step, on the same data)."""
    out = {}
    for name, fn in calls.items():
        try:
            out[name] = fn()
        except Exception as e:  # the tests compare what each process raised
            out[name] = f"{type(e).__name__}: {e}"
    return out


def graph_container(mesh, graph: str, device):
    """``graph``'s container on ``mesh`` (the ingest with halo lists)."""
    row, col, vals, shape = GRAPHS[graph]()
    return ShardedCSR.from_coo_sharded(*(torch.as_tensor(a).to(device) for a in (row, col, vals)), shape,
                                       mesh).with_halo()


def run_ring(mesh, graph: str, device) -> dict:
    """Each ring of :data:`RING` on ``graph``'s container: ``{name:
    result}``, the counts as ints and every process's whole weights."""
    sh = graph_container(mesh, graph, device)
    calls = {
        "ring.triangle_count": lambda: ring.triangle_count(sh, mesh),
        "ring.triangle_count directed": lambda: ring.triangle_count(sh, mesh, directed=True),
        "ring.jaccard_weights": lambda: ring.jaccard_weights(sh, mesh),
        "ring.triangle_count_sparse": lambda: ring.triangle_count_sparse(sh, mesh),
        "ring.jaccard_weights_sparse": lambda: ring.jaccard_weights_sparse(sh, mesh),
        "ring.jaccard_flat": lambda: ring.jaccard_flat(sh, mesh),
    }
    assert tuple(calls) == RING
    return caught(calls)


def tiles(t) -> dict:
    """A ``Sharded2DCSR``: its tiles' fields flat in (i, j) order (this
    process's, ``None`` in a remote tile's slot), the flat indices of its
    own, its counts, grid, widths and every field's ``stacked``."""
    dc = t.grid[1]
    out = {name: None if getattr(t, name) is None else tuple(x for row in getattr(t, name) for x in row)
           for name in TILE_FIELDS}
    out.update(local=tuple(i * dc + j for i, j in t.local), nnz_counts=t.nnz_counts, grid=t.grid,
               rows_per_tile=t.rows_per_tile, width=t.width, stacked={name: t.stacked(name) for name in TILE_FIELDS})
    return out


def run_containers(mesh, mesh_2d, graph: str, device) -> dict:
    """Each call of :data:`CONTAINERS` on ``graph``: ``sharded2d`` on
    ``mesh_2d`` with its axes either way round (a ``Sharded2DCSR`` as
    :func:`tiles`' dict), ``stacked`` of every field of the 1-D container
    on ``mesh``, and ``to`` a mesh whose shards alternate between the
    processes (every other shard changes owner) and to ``device``'s
    context (as :func:`container`'s dicts with their ``local`` shards)."""
    sh = graph_container(mesh, graph, device)
    csr = sh.to_csr()
    x = torch.as_tensor(function_inputs(sh.shape)["x"]).to(device)
    built = {o: sharded2d.Sharded2DCSR.from_csr(csr, mesh_2d, axes) for o, axes in ORIENTATIONS.items()}
    d = mesh.size
    alternate = Mesh(list(mesh.devices), ("x",), owners=[k % 2 if mesh.spans_processes else 0 for k in range(d)],
                     rank=mesh.rank)

    def moved(context):
        out = sh.to(context)
        return {**container(out), "local": out.local, "spans": out._mesh is not None}

    calls = {}
    for o in ORIENTATIONS:
        calls[f"Sharded2DCSR.from_csr {o}"] = lambda o=o: tiles(built[o])
        calls[f"sharded2d.spmv {o}"] = lambda o=o: sharded2d.spmv(built[o], x, mesh_2d)
        calls[f"sharded2d.degrees {o}"] = lambda o=o: sharded2d.degrees(built[o], mesh_2d)
    calls["ShardedCSR.stacked"] = lambda: {name: sh.stacked(name) for name in FIELDS}
    calls["ShardedCSR.to mesh"] = lambda: moved(MeshContext(alternate))
    calls["ShardedCSR.to device"] = lambda: moved(context_for(device))
    assert tuple(sorted(calls)) == tuple(sorted(CONTAINERS))
    return caught({name: calls[name] for name in CONTAINERS})


def suite_graph(device):
    return bench_suite.synthetic_graph(SUITE_N, 6, device=device)


def run_suite(device, shards: int) -> dict:
    """``bench_suite.run_distributed`` on one graph of ``SUITE_N`` vertices
    (the ring's block runs), ``shards`` shards (a process, in a group)."""
    saved = dict(bench_suite.MATRICES)
    bench_suite.MATRICES["rand-20k"] = suite_graph
    try:
        return bench_suite.run_distributed(device=str(device), shards=shards)
    finally:
        bench_suite.MATRICES.clear()
        bench_suite.MATRICES.update(saved)


def write_tool_mtx(path) -> None:
    """The tool graph as a general real MTX file."""
    row, col, vals, (n, m) = tool_graph()
    indptr = torch.as_tensor(np.concatenate([[0], np.cumsum(np.bincount(row, minlength=n))]))
    IOBase.write_csr_to_mtx(CSR(indptr, torch.as_tensor(col), torch.as_tensor(vals), (n, m)), str(path))


def run_experiment(mesh, path) -> dict:
    """A ``ConcreteExperiment`` of ``load_sharded_csr(mesh)``,
    ``distributed_reorder("rcm")`` and ``distributed_spmv_kernel`` on the
    MTX file ``path``, run twice: the order and each run's y."""
    exp = experiment.ConcreteExperiment()
    exp.add_data_loader(experiment.load_sharded_csr(mesh), [([str(path)], None)])
    exp.add_preprocess("rcm", experiment.distributed_reorder("rcm"))
    exp.add_kernel("spmv", experiment.distributed_spmv_kernel)
    exp.run(times=2, store_auxiliary=True)
    return {"order": exp.get_auxiliary()[f"preprocess,rcm,{path}"][2], "y": exp.get_results()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--shards", default="2,4", help="shards per process, one mesh each")
    ap.add_argument("--backend", default="gloo")
    args = ap.parse_args()
    torch.set_num_threads(1)
    assert multihost.initialize(backend=args.backend, timeout=60), "no process group"
    import torch.distributed as tdist

    device = torch.device(args.device)
    if args.backend == "nccl":
        device = torch.device("cuda", tdist.get_rank())
    out = {"rank": tdist.get_rank(), "backend": tdist.get_backend(), "local_entry_counts":
           multihost.local_entry_counts(1000)}
    mtx = Path(args.out) / "tool.mtx"
    if out["rank"] == 0:
        write_tool_mtx(mtx)
    tdist.barrier()
    for s in (int(v) for v in args.shards.split(",")):
        mesh = multihost.global_mesh(devices=[device] * s)
        collectives.reset_traffic()
        res = {"mesh": (mesh.size, mesh.local, mesh.axis_owners("x"), str(mesh.first_device)),
               "collectives": run_collectives(mesh, device)}
        res.update({graph: run_path(mesh, graph, device) for graph in GRAPHS})
        res["blocks"] = {graph: run_blocks(mesh, graph, device) for graph in GRAPHS}
        res["functions"] = {graph: run_functions(mesh, graph, device) for graph in GRAPHS}
        res["multilevel"] = {graph: run_multilevel(mesh, graph, device) for graph in GRAPHS}
        res["ring"] = {graph: run_ring(mesh, graph, device) for graph in GRAPHS}
        mesh_2d = multihost.global_mesh_2d((2, s), devices=[device] * s)
        res["mesh_2d"] = (mesh_2d.owners.tolist(), mesh_2d.axis_names)
        res["containers"] = {graph: run_containers(mesh, mesh_2d, graph, device) for graph in GRAPHS}
        res["suite"] = run_suite(device, s)
        res["experiment"] = run_experiment(mesh, mtx)
        res["traffic"] = collectives.traffic()
        out[s] = res
    torch.save(out, Path(args.out) / f"rank{out['rank']}.pt")
    tdist.destroy_process_group()


if __name__ == "__main__":
    main()
