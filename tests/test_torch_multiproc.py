"""The distributed tier on a mesh that spans two processes, on the CPU.

One group of two gloo processes (``tests/torch_multiproc_child.py``,
started once for the module by ``multihost.launch`` under a time limit)
builds ``global_mesh(devices=["cpu"] * S)`` for S = 2 and 4 (4 and 8
shards) and runs every collective, the host read, the distributed ingest's
path (``from_coo_sharded`` → ``with_halo`` → ``halo.spmv`` →
``dist.rcm_reorder``, with ``to_csr``, ``bfs_levels``, ``degrees`` and
``degree_reorder``), the twelve functions of ``child.FUNCTIONS`` (the rest
of ``dist`` and ``halo``'s flat half), the eight calls of
``child.MULTILEVEL`` (``halo``'s multilevel half and SlashBurn,
``ShardedCSR.from_csr`` and ``from_csr_balanced``), the six rings of
``child.RING``, the containers' calls of ``child.CONTAINERS``
(``Sharded2DCSR.from_csr``, ``spmv`` and ``degrees`` on
``global_mesh_2d((2, S))`` with its axes either way round,
``ShardedCSR.stacked`` and ``to``), the suite's ``run_distributed`` and an
experiment of ``load_sharded_csr`` and ``distributed_reorder("rcm")``. Each
process's results, and the ``stats`` the functions keep, must equal the
single-process mesh of as many CPU shards on the same inputs bit for bit,
field by field (the suite's table but for its times); where the
single-process call raises (on the wide graph), every process must raise
the same error. On ``tools/multiproc_dcn.py``'s graph the path and the
functions must also give the JAX package's results on 4 and 8 virtual CPU
devices: y within rtol 1e-5, atol 1e-5 (as ``test_torch_halo.py``), the
profile and the heatmap within rtol 1e-6 (as ``test_torch_parallel.py``),
every integer result exactly; so must the matching, the coarse map and
counts, SlashBurn's orders (against the JAX host SlashBurn),
``from_csr``'s fields, the rings (counts exactly, weights bit for bit, as
``test_torch_ring.py``) and ``sharded2d`` (the tiles exactly, y within
rtol 1e-5, atol 1e-5, the degrees exactly).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_multiproc_child as child
from sparsebase_tpu_torch.parallel import ShardedCSR, make_mesh, make_mesh_2d, multihost

CHILD = str(Path(child.__file__).resolve())
PER_PROCESS = (2, 4)
GROUP_TIME_LIMIT = 240  # seconds for the whole group; it takes about 40


@pytest.fixture(scope="module")
def group_dir(tmp_path_factory):
    """Where the group saves its results and rank 0 writes the MTX file."""
    return tmp_path_factory.mktemp("group")


@pytest.fixture(scope="module")
def group(group_dir):
    """Each rank's saved results."""
    multihost.launch([sys.executable, CHILD, "--out", str(group_dir), "--shards", ",".join(map(str, PER_PROCESS))],
                     2, timeout=GROUP_TIME_LIMIT)
    return [torch.load(group_dir / f"rank{r}.pt", weights_only=False) for r in range(2)]


@pytest.fixture(scope="module", params=PER_PROCESS, ids=lambda s: f"2x{s}")
def per_process(request):
    return request.param


def single(s: int):
    """The single-process mesh of the group's 2·s shards."""
    return make_mesh(devices=["cpu"] * (2 * s))


def single_2d(s: int):
    """The single-process 2-D mesh of the group's (2, s) shards."""
    return make_mesh_2d((2, s), devices=["cpu"] * (2 * s))


def assert_same(got, want, what):
    """``got`` (one process's) equal to ``want`` (the single process's):
    tensors bit for bit with their dtypes, remote slots None, dicts key by
    key."""
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype and got.shape == want.shape, what
        assert torch.equal(got.to(want.device), want), what
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for k, (g, w) in enumerate(zip(got, want)):
            if g is None:
                continue  # another process's shard
            assert_same(g, w, f"{what}[{k}]")
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), what
        for key, w in want.items():
            assert_same(got[key], w, f"{what} {key}")
    else:
        assert got == want, what


def assert_local(got, want, local, what):
    """A sharded field: this process's shards equal, the others None."""
    assert len(got) == len(want), what
    for k, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (k not in local), f"{what}[{k}]"
        if g is not None:
            assert_same(g, w, f"{what}[{k}]")


def test_group(group, per_process):
    for rank, res in enumerate(group):
        assert res["rank"] == rank and res["backend"] == "gloo"
        size, local, owners, first = res[per_process]["mesh"]
        d = 2 * per_process
        assert size == d and owners == (0,) * per_process + (1,) * per_process
        assert local == tuple(range(rank * per_process, (rank + 1) * per_process)) and first == "cpu"
    assert [res["local_entry_counts"] for res in group] == [(0, 500), (500, 500)]
    for res in group:  # global_mesh_2d lays the processes' devices out row-major
        assert res[per_process]["mesh_2d"] == ([[0] * per_process, [1] * per_process], ("x", "y"))
    traffic = group[0][per_process]["traffic"]
    assert traffic["crossed_bytes"] > 0 and traffic["exchanges"] > 0 and traffic["staged_bytes"] == 0


@pytest.mark.parametrize("name", child.COLLECTIVES)
def test_collective(group, per_process, name):
    want = child.run_collectives(single(per_process), torch.device("cpu"))[name]
    for res in group:
        local = res[per_process]["mesh"][1]
        got = res[per_process]["collectives"][name]
        if name in ("host_fetch", "gather ragged"):
            assert_same(got, want, name)  # every process reads every shard's values
        else:
            assert_local(got, want, local, name)


@pytest.fixture(scope="module")
def single_paths():
    """The path on the single-process meshes, once."""
    return {(s, g): child.run_path(single(s), g, torch.device("cpu")) for s in PER_PROCESS for g in child.GRAPHS}


@pytest.mark.parametrize("graph", list(child.GRAPHS))
def test_path_equals_single_process(group, per_process, single_paths, graph):
    want = single_paths[per_process, graph]
    for res in group:
        local = res[per_process]["mesh"][1]
        got = res[per_process][graph]
        for name in child.FIELDS:
            assert_local(got[name], want[name], local, f"{graph} {name}")
        for name in ("stats", "nnz_counts", "nnz", "width", "halo_width", "halo_bytes", "step_comm_bytes", "y",
                     "order", "levels", "degrees", "degree_order", "csr"):
            assert_same(got[name], want[name], f"{graph} {name}")


@pytest.mark.parametrize("graph", list(child.GRAPHS))
def test_blocks_ingest_equals_the_joined_ingest(group, per_process, graph):
    """``from_coo_blocks`` on consecutive blocks of unequal lengths, each
    process holding only its own shards' blocks, equals
    ``from_coo_sharded`` of the joined entries on the single-process mesh,
    field for field (the route's capacity follows the blocks' loads, the
    widths do not)."""
    mesh = single(per_process)
    row, col, vals, shape = child.GRAPHS[graph]()
    sh = ShardedCSR.from_coo_sharded(torch.as_tensor(row), torch.as_tensor(col), torch.as_tensor(vals), shape,
                                     mesh).with_halo()
    want = child.run_blocks(mesh, graph, torch.device("cpu"))
    for name in child.FIELDS:
        assert_same(want[name], getattr(sh, name), f"{graph} {name}")
    for name in ("nnz_counts", "width", "halo_width"):
        assert want[name] == getattr(sh, name), f"{graph} {name}"
    for res in group:
        local = res[per_process]["mesh"][1]
        got = res[per_process]["blocks"][graph]
        for name in child.FIELDS:
            assert_local(got[name], want[name], local, f"{graph} {name}")
        for name in ("stats", "nnz_counts", "width", "halo_width"):
            assert_same(got[name], want[name], f"{graph} {name}")


@pytest.fixture(scope="module")
def jax_tool_sharded():
    """The JAX package's ingest of the tool's graph on 4 and 8 virtual CPU
    devices, once (about 10 s each): ``{shards per process: (mesh,
    sharded)}``."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from sparsebase_tpu.parallel import make_mesh as ref_make_mesh
    from sparsebase_tpu.parallel.sharded import ShardedCSR as RefShardedCSR

    row, col, vals, shape = child.tool_graph()
    out = {}
    for s in PER_PROCESS:
        assert len(jax.devices()) >= 2 * s, "conftest must provide 8 virtual devices"
        mesh = ref_make_mesh(2 * s)
        out[s] = mesh, RefShardedCSR.from_coo_sharded(jnp.asarray(row), jnp.asarray(col), jnp.asarray(vals), shape,
                                                      mesh).with_halo()
    return out


@pytest.fixture(scope="module")
def jax_tool_path(jax_tool_sharded):
    """The JAX package's path on the tool's graph on 4 and 8 virtual CPU
    devices: ``{d: (y, order)}``."""
    import jax.numpy as jnp

    from sparsebase_tpu.parallel import dist as ref_dist
    from sparsebase_tpu.parallel import halo as ref_halo

    shape = child.tool_graph()[3]
    x = np.random.default_rng(7).standard_normal(shape[0]).astype(np.float32)
    out = {}
    for s, (mesh, sh) in jax_tool_sharded.items():
        y = np.asarray(ref_halo.spmv(sh, jnp.asarray(x), mesh)).reshape(-1)[: shape[0]]
        out[s] = (y, np.asarray(ref_dist.rcm_reorder(sh, mesh)).reshape(-1)[: shape[0]], int(sh.nnz))
    return out


def test_path_equals_jax(group, per_process, jax_tool_path):
    y, order, nnz = jax_tool_path[per_process]
    for res in group:
        got = res[per_process]["tool"]
        assert got["nnz"] == nnz
        np.testing.assert_allclose(got["y"].numpy(), y, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got["order"].numpy(), order)


@pytest.fixture(scope="module")
def single_functions():
    """The functions on the single-process meshes, once."""
    return {(s, g): child.run_functions(single(s), g, torch.device("cpu")) for s in PER_PROCESS for g in child.GRAPHS}


@pytest.mark.parametrize("graph", list(child.GRAPHS))
@pytest.mark.parametrize("name", child.FUNCTIONS)
def test_function_equals_single_process(group, per_process, single_functions, name, graph):
    want, want_stats = single_functions[per_process, graph][name]
    for res in group:
        got, stats = res[per_process]["functions"][graph][name]
        if isinstance(want, dict):  # structure_features
            assert set(got) == set(want), name
            for key in want:
                assert_same(got[key], want[key], f"{graph} {name} {key}")
        else:
            assert_same(got, want, f"{graph} {name}")
        assert stats == want_stats, f"{graph} {name} stats"


def jax_calls(sh, mesh, inputs) -> dict:
    """The JAX package's counterpart of ``child.function_calls``."""
    from sparsebase_tpu.parallel import dist as ref_dist
    from sparsebase_tpu.parallel import halo as ref_halo

    x, labels, weights, order_r, order_c = (inputs[k] for k in ("x", "labels", "weights", "order_r", "order_c"))
    k = child.PARTS
    calls = {
        "dist.spmv": lambda: ref_dist.spmv(sh, x, mesh),
        "dist.edge_cut": lambda: ref_dist.edge_cut(sh, labels, mesh),
        "dist.structure_features": lambda: ref_dist.structure_features(sh, mesh),
        "dist.label_prop_partition": lambda: ref_dist.label_prop_partition(sh, k, mesh, num_iters=8),
        "dist.refine_partition": lambda: ref_dist.refine_partition(sh, labels, k, mesh),
        "dist.reorder_heatmap": lambda: ref_dist.reorder_heatmap(sh, order_r, order_c, mesh, child.HEATMAP_PARTS),
        "halo.bfs_levels": lambda: ref_halo.bfs_levels(sh, 0, mesh),
        "halo.label_prop_partition": lambda: ref_halo.label_prop_partition(sh, k, mesh, num_iters=8,
                                                                           vertex_weights=weights),
        "halo.connected_components": lambda: ref_halo.connected_components(sh, mesh),
        "halo.rcm_reorder": lambda: ref_halo.rcm_reorder(sh, mesh),
        "halo.edge_cut": lambda: ref_halo.edge_cut(sh, labels, mesh),
        "halo.refine_partition": lambda: ref_halo.refine_partition(sh, labels, k, mesh),
    }
    assert tuple(calls) == child.FUNCTIONS
    return calls


@pytest.fixture(scope="module")
def jax_tool_functions(jax_tool_sharded):
    """The JAX package's functions on the tool's graph on 4 and 8 virtual
    CPU devices: ``{(shards per process, name): result}``."""
    import jax.numpy as jnp

    shape = child.tool_graph()[3]
    inputs = {k: jnp.asarray(v) for k, v in child.function_inputs(shape).items()}
    out = {}
    for s, (mesh, sh) in jax_tool_sharded.items():
        for name, fn in jax_calls(sh, mesh, inputs).items():
            got = fn()
            if isinstance(got, dict):
                out[s, name] = {key: np.asarray(v) for key, v in got.items()}
            else:  # a vector cut to n; a scalar or the heatmap's grid as it is
                got = np.asarray(got)
                out[s, name] = got.reshape(-1)[: shape[0]] if got.ndim == 1 else got
    return out


@pytest.mark.parametrize("name", child.FUNCTIONS)
def test_function_equals_jax(group, per_process, jax_tool_functions, name):
    want = jax_tool_functions[per_process, name]
    for res in group:
        got, _ = res[per_process]["functions"]["tool"][name]
        if name == "dist.structure_features":
            assert set(got) == set(want)
            for key in ("bandwidth", "nnz", "min_degree", "max_degree", "avg_degree"):
                assert got[key].item() == want[key].item(), key
            np.testing.assert_allclose(got["profile"].item(), float(want["profile"]), rtol=1e-6)
        elif name == "dist.spmv":
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        elif name == "dist.reorder_heatmap":
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        else:
            assert got.shape == want.shape, name
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def single_multilevel():
    """The multilevel calls on the single-process meshes, once."""
    return {(s, g): child.run_multilevel(single(s), g, torch.device("cpu")) for s in PER_PROCESS for g in child.GRAPHS}


def assert_result(got, want, local, what):
    """A multilevel call's result: a container's fields (dicts of
    :func:`child.container`) held shard by shard, tuples item by item."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), what
        for key, w in want.items():
            if key in child.FIELDS and w is not None:
                assert_local(got[key], w, local, f"{what} {key}")
            else:
                assert_same(got[key], w, f"{what} {key}")
    elif isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for k, (g, w) in enumerate(zip(got, want)):
            assert_result(g, w, local, f"{what}[{k}]")
    else:
        assert_same(got, want, what)  # a tensor, or the error raised


# on the tool graph each call reaches the branch it is there for
BRANCHES = {
    "halo.bfs_levels_multilevel": lambda st: st["levels"] >= 2,
    "halo.rcm_reorder_ml": lambda st: st["levels"] >= 2,
    "halo.multilevel_partition": lambda st: st["sizes"][-1] <= 4096,  # the coarsest graph on the host
    "halo.slashburn_reorder": lambda st: st["on the mesh"]["compactions"] >= 1 and st["host tail"]["host_tail"] > 0,
}


@pytest.mark.parametrize("graph", list(child.GRAPHS))
@pytest.mark.parametrize("name", child.MULTILEVEL)
def test_multilevel_equals_single_process(group, per_process, single_multilevel, name, graph):
    want, want_stats = single_multilevel[per_process, graph][name]
    if graph == "tool":
        assert not isinstance(want, str), want
        assert BRANCHES.get(name, lambda st: True)(want_stats), want_stats
    for res in group:
        local = res[per_process]["mesh"][1]
        got, stats = res[per_process]["multilevel"][graph][name]
        assert_result(got, want, local, f"{graph} {name}")
        assert stats == want_stats, f"{graph} {name} stats"


@pytest.fixture(scope="module")
def jax_tool_multilevel(jax_tool_sharded):
    """The JAX package on the tool's graph on 4 and 8 virtual CPU devices:
    ``{shards per process: {name: result}}``, with the JAX host SlashBurn's
    two orders (``hub_order`` on, then off)."""
    from sparsebase_tpu.formats.csr import CSR as RefCSR
    from sparsebase_tpu.ops.reorder.slashburn import SlashburnReorderParams, _slashburn_host
    from sparsebase_tpu.parallel import halo as ref_halo
    from sparsebase_tpu.parallel.sharded import ShardedCSR as RefShardedCSR

    row, col, vals, shape = child.tool_graph()
    indptr = np.concatenate([[0], np.cumsum(np.bincount(row, minlength=shape[0]))]).astype(np.int32)
    k_size = child.MULTILEVEL_ARGS["tool"][1]
    orders = tuple(np.asarray(_slashburn_host(RefCSR(indptr, col, None, shape),
                                              SlashburnReorderParams(k_size=k_size, greedy=False, hub_order=h)))
                   for h in (True, False))
    out = {}
    for s, (mesh, sh) in jax_tool_sharded.items():
        match = ref_halo.heavy_edge_matching(sh, mesh)
        coarse, cid = ref_halo.coarsen(sh, match, mesh, return_mapping=True)
        cut = RefShardedCSR.from_csr(RefCSR(indptr, col, vals, shape), mesh)
        out[s] = {"halo.heavy_edge_matching": np.asarray(match), "halo.coarsen": (np.asarray(coarse.nnz_local),
                                                                                  np.asarray(cid)),
                  "halo.slashburn_reorder": orders,
                  "ShardedCSR.from_csr": {name: np.asarray(getattr(cut, name)) for name in child.FIELDS}}
    return out


@pytest.mark.parametrize("name", ["halo.heavy_edge_matching", "halo.coarsen", "halo.slashburn_reorder",
                                  "ShardedCSR.from_csr"])
def test_multilevel_equals_jax(group, per_process, jax_tool_multilevel, name):
    want = jax_tool_multilevel[per_process][name]
    for res in group:
        local = res[per_process]["mesh"][1]
        got, _ = res[per_process]["multilevel"]["tool"][name]
        if name == "halo.coarsen":
            coarse, cid = got
            assert list(coarse["nnz_counts"]) == want[0].reshape(-1).tolist()
            np.testing.assert_array_equal(cid.numpy(), want[1].reshape(-1)[: cid.shape[0]])
        elif name == "halo.slashburn_reorder":
            for order, w in zip(got, want):
                np.testing.assert_array_equal(order.numpy(), w)
        elif name == "ShardedCSR.from_csr":
            for field, w in want.items():
                for k in local:
                    np.testing.assert_array_equal(got[field][k].numpy(), w[k], err_msg=f"{field}[{k}]")
        else:
            np.testing.assert_array_equal(got.numpy(), want.reshape(-1)[: got.shape[0]])


@pytest.fixture(scope="module")
def single_rings():
    """The rings on the single-process meshes, once."""
    return {(s, g): child.run_ring(single(s), g, torch.device("cpu")) for s in PER_PROCESS for g in child.GRAPHS}


def assert_ring(got, want, local, what):
    """A ring's result: the padded weights shard by shard; a count, the
    whole flat weights or the error raised as they are."""
    if isinstance(want, tuple):
        assert_local(got, want, local, what)
    else:
        assert type(got) is type(want), what
        assert_same(got, want, what)


@pytest.mark.parametrize("graph", list(child.GRAPHS))
@pytest.mark.parametrize("name", child.RING)
def test_ring_equals_single_process(group, per_process, single_rings, name, graph):
    want = single_rings[per_process, graph][name]
    if graph == "tool":
        assert not isinstance(want, str), want
    for res in group:
        assert_ring(res[per_process]["ring"][graph][name], want, res[per_process]["mesh"][1], f"{graph} {name}")


@pytest.fixture(scope="module")
def single_containers():
    """The containers' calls on the single-process meshes, once."""
    return {(s, g): child.run_containers(single(s), single_2d(s), g, torch.device("cpu")) for s in PER_PROCESS
            for g in child.GRAPHS}


def assert_moved(got, want, local, what):
    """A container after ``to``: its own shards' fields (those of the
    target's shards it owns), counts and widths."""
    assert got["local"] == tuple(local), what
    for key, w in want.items():
        if key in child.FIELDS and w is not None:
            assert_local(got[key], w, local, f"{what} {key}")
        elif key not in ("local", "spans"):
            assert_same(got[key], w, f"{what} {key}")


def assert_container(got, want, name, per_process, rank, what):
    """A call of ``child.CONTAINERS`` on rank ``rank`` of the group of two
    processes of ``per_process`` shards each: the tiles or shards it owns,
    and every process's whole of the rest."""
    d = 2 * per_process
    if name.startswith("Sharded2DCSR.from_csr"):
        # (2, S) tiles, a row on one process; or (S, 2), each row across both
        rows_on_one = name.endswith("x,y")
        tiles = [k for k in range(d) if (k // per_process if rows_on_one else k % 2) == rank]
        assert got["local"] == tuple(tiles), what
        for key, w in want.items():
            if key in child.TILE_FIELDS and w is not None:
                assert_local(got[key], w, tiles, f"{what} {key}")
            elif key not in ("local", "stacked"):
                assert_same(got[key], w, f"{what} {key}")
        for key, w in want["stacked"].items():  # every tile, on every process
            assert_same(got["stacked"][key], w, f"{what} stacked {key}")
    elif name == "ShardedCSR.to mesh":
        assert got["spans"] and not want["spans"], what
        assert_moved(got, want, [k for k in range(d) if k % 2 == rank], what)
    elif name == "ShardedCSR.to device":
        assert not got["spans"] and not want["spans"], what
        assert_moved(got, want, range(d), what)
    else:  # y, the degrees and the stacked fields: the whole of them on every process
        assert_same(got, want, what)


@pytest.mark.parametrize("graph", list(child.GRAPHS))
@pytest.mark.parametrize("name", child.CONTAINERS)
def test_container_equals_single_process(group, per_process, single_containers, name, graph):
    want = single_containers[per_process, graph][name]
    assert not isinstance(want, str), want
    for rank, res in enumerate(group):
        assert_container(res[per_process]["containers"][graph][name], want, name, per_process, rank,
                         f"{graph} {name} rank {rank}")


def without_times(entry):
    if isinstance(entry, dict):
        return {k: without_times(v) for k, v in entry.items() if k != "seconds"}
    return entry


def test_suite_equals_single_process(group, per_process):
    want = child.run_suite(torch.device("cpu"), 2 * per_process)
    entry = want["rand-20k"]
    assert want["devices"] == 2 * per_process and entry["n"] == child.SUITE_N
    assert entry["ring_mxu"]["triangles_match_host"] and entry["ring_mxu"]["jaccard_match_host"]
    for res in group:
        assert without_times(res[per_process]["suite"]) == without_times(want)


def test_experiment_equals_single_process(group, group_dir, per_process):
    want = child.run_experiment(single(per_process), group_dir / "tool.mtx")
    assert len(want["y"]) == 2
    for res in group:
        got = res[per_process]["experiment"]
        assert_same(got["order"], want["order"], "order")
        assert set(got["y"]) == set(want["y"])
        for key, y in want["y"].items():
            assert_same(got["y"][key], y, key)


@pytest.fixture(scope="module")
def jax_tool_rings(jax_tool_sharded):
    """The JAX package's rings on the tool's graph on 4 and 8 virtual CPU
    devices: ``{(shards per process, name): result}``."""
    from sparsebase_tpu.parallel import ring as ref_ring

    out = {}
    for s, (mesh, sh) in jax_tool_sharded.items():
        calls = {
            "ring.triangle_count": lambda: ref_ring.triangle_count(sh, mesh),
            "ring.triangle_count directed": lambda: ref_ring.triangle_count(sh, mesh, directed=True),
            "ring.jaccard_weights": lambda: ref_ring.jaccard_weights(sh, mesh),
            "ring.triangle_count_sparse": lambda: ref_ring.triangle_count_sparse(sh, mesh),
            "ring.jaccard_weights_sparse": lambda: ref_ring.jaccard_weights_sparse(sh, mesh),
            "ring.jaccard_flat": lambda: ref_ring.jaccard_flat(sh, mesh),
        }
        assert tuple(calls) == child.RING
        for name, fn in calls.items():
            got = fn()
            out[s, name] = got if isinstance(got, int) else np.asarray(got)
    return out


@pytest.mark.parametrize("name", child.RING)
def test_ring_equals_jax(group, per_process, jax_tool_rings, name):
    want = jax_tool_rings[per_process, name]
    for res in group:
        local = res[per_process]["mesh"][1]
        got = res[per_process]["ring"]["tool"][name]
        if isinstance(want, int):
            assert isinstance(got, int) and got == want, name
        elif name == "ring.jaccard_flat":
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)
        else:  # the padded (d, width) weights, pad slots 0
            for k in local:
                assert got[k].dtype == torch.float32 and got[k].shape == want[k].shape, k
                np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=f"{name}[{k}]")


@pytest.fixture(scope="module")
def jax_tool_sharded2d():
    """The JAX ``sharded2d`` on the tool's graph on (2, S) meshes of 4 and 8
    virtual CPU devices, both orientations: ``{(shards per process,
    orientation): (tile arrays, y, degrees)}``."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from sparsebase_tpu.formats.csr import CSR as RefCSR
    from sparsebase_tpu.parallel import make_mesh_2d as ref_make_mesh_2d
    from sparsebase_tpu.parallel import sharded2d as ref_sharded2d

    row, col, vals, shape = child.tool_graph()
    indptr = np.concatenate([[0], np.cumsum(np.bincount(row, minlength=shape[0]))]).astype(np.int32)
    x = jnp.asarray(child.function_inputs(shape)["x"])
    out = {}
    for s in PER_PROCESS:
        assert len(jax.devices()) >= 2 * s, "conftest must provide 8 virtual devices"
        mesh = ref_make_mesh_2d((2, s))
        for o, axes in child.ORIENTATIONS.items():
            t = ref_sharded2d.Sharded2DCSR.from_csr(RefCSR(indptr, col, vals, shape), mesh, axes)
            out[s, o] = ({name: np.asarray(getattr(t, name)) for name in child.TILE_FIELDS},
                         np.asarray(ref_sharded2d.spmv(t, x, mesh)), np.asarray(ref_sharded2d.degrees(t, mesh)))
    return out


@pytest.mark.parametrize("orientation", list(child.ORIENTATIONS))
@pytest.mark.parametrize("name", ["Sharded2DCSR.from_csr", "sharded2d.spmv", "sharded2d.degrees"])
def test_sharded2d_equals_jax(group, per_process, jax_tool_sharded2d, name, orientation):
    fields, y, deg = jax_tool_sharded2d[per_process, orientation]
    for res in group:
        got = res[per_process]["containers"]["tool"][f"{name} {orientation}"]
        if name == "Sharded2DCSR.from_csr":
            for field, w in fields.items():
                np.testing.assert_array_equal(got["stacked"][field].numpy(), w, err_msg=field)
        elif name == "sharded2d.spmv":
            np.testing.assert_allclose(got.numpy(), y, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(got.numpy(), deg)
