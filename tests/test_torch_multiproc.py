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
``ShardedCSR.from_csr`` and ``from_csr_balanced``) and the guard of every
function that does not run across processes. Each process's results, and
the ``stats`` the functions keep, must equal the single-process mesh of as
many CPU shards on the same inputs bit for bit, field by field; where the
single-process call raises (on the wide graph), every process must raise
the same error. On ``tools/multiproc_dcn.py``'s graph the path and the
functions must also give the JAX package's results on 4 and 8 virtual CPU
devices: y within rtol 1e-5, atol 1e-5 (as ``test_torch_halo.py``), the
profile and the heatmap within rtol 1e-6 (as ``test_torch_parallel.py``),
every integer result exactly; so must the matching, the coarse map and
counts, SlashBurn's orders (against the JAX host SlashBurn) and
``from_csr``'s fields.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_multiproc_child as child
from sparsebase_tpu_torch.parallel import make_mesh, multihost

CHILD = str(Path(child.__file__).resolve())
PER_PROCESS = (2, 4)
GROUP_TIME_LIMIT = 240  # seconds for the whole group; it takes about 25


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Each rank's saved results."""
    out = tmp_path_factory.mktemp("group")
    multihost.launch([sys.executable, CHILD, "--out", str(out), "--shards", ",".join(map(str, PER_PROCESS))], 2,
                     timeout=GROUP_TIME_LIMIT)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]


@pytest.fixture(scope="module", params=PER_PROCESS, ids=lambda s: f"2x{s}")
def per_process(request):
    return request.param


def single(s: int):
    """The single-process mesh of the group's 2·s shards."""
    return make_mesh(devices=["cpu"] * (2 * s))


def assert_same(got, want, what):
    """``got`` (one process's) equal to ``want`` (the single process's):
    tensors bit for bit with their dtypes, remote slots None."""
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype and got.shape == want.shape, what
        assert torch.equal(got.to(want.device), want), what
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for k, (g, w) in enumerate(zip(got, want)):
            if g is None:
                continue  # another process's shard
            assert_same(g, w, f"{what}[{k}]")
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


@pytest.mark.parametrize("name", child.GUARDED)
def test_guard(group, per_process, name):
    for res in group:
        said = res[per_process]["guards"][name]
        assert said.startswith("NotImplementedError: ") and "ROADMAP.md, item 10" in said, said


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
