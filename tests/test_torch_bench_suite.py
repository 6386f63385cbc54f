"""Port parity for the benchmark suite (``bench_suite.py``), on the CPU.

Both packages generate the suite's graphs with numpy from a seed, so the
graphs must be identical, and every field of a matrix's entry that is not a
time must equal the JAX entry's: bandwidth, profile and fill of every
ordering, edge cuts, random cuts, balance, λ−1. The JAX side runs its own
``run`` with its three matrices monkeypatched to the test's (the JAX package
is not edited); the port's ``run_matrix`` takes one matrix.
"""

import copy
import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import sparsebase_tpu.bench_suite as ref_suite  # noqa: E402
from sparsebase_tpu.bases import IOBase as RefIOBase  # noqa: E402

import sparsebase_tpu_torch.bench_suite as suite  # noqa: E402
from sparsebase_tpu_torch.interop import to_numpy  # noqa: E402

GRAPHS = {  # the test's matrices: (port graph, JAX graph), each from the same draws
    "rand-2k": (lambda: suite.synthetic_graph(2_000, 8, device="cpu"), lambda: ref_suite.synthetic_graph(2_000, 8)),
    "mesh-1.6k": (lambda: suite.mesh_graph(40, device="cpu"), lambda: ref_suite.mesh_graph(40)),
}


def strip_times(results):
    """A copy of a results dict with every time field set to 0."""
    out = copy.deepcopy(results)
    for e in out.values():
        e["convert_roundtrip_nnz_per_s"] = 0
        for r in e["reorder"].values():
            r["seconds"] = 0
        if "hypergraph_k4" in e:
            e["hypergraph_k4"]["seconds"] = 0
    return out


@pytest.fixture(scope="module")
def ref_entries():
    """The JAX suite's entries of the test's matrices, from its own ``run``
    with ``ash958_graph``, ``synthetic_graph`` and ``mesh_graph`` patched."""
    (name_a, (_, ref_a)), (name_b, (_, ref_b)) = GRAPHS.items()
    ga, gb = ref_a(), ref_b()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_suite, "ash958_graph", lambda: ga)
        mp.setattr(ref_suite, "synthetic_graph", lambda *a, **k: gb)
        mp.setattr(ref_suite, "mesh_graph", lambda *a, **k: gb)
        results = ref_suite.run()
    return {name_a: results["ash958(sym)"], name_b: results["rand-20k"]}


@pytest.fixture(scope="module")
def port_entries():
    out = {}
    for name, (port, _) in GRAPHS.items():
        out.update(suite.run_matrix(name, port()))
    return out


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("case", ["synthetic-300-4", "synthetic-2000-8", "mesh-12", "mesh-40"])
def test_graphs_are_identical_in_both_packages(case, seed):
    kind, *size = case.split("-")
    size = [int(s) for s in size]
    if kind == "synthetic":
        port, ref = suite.synthetic_graph(*size, seed=seed, device="cpu"), ref_suite.synthetic_graph(*size, seed=seed)
    else:
        port, ref = suite.mesh_graph(*size, seed=seed, device="cpu"), ref_suite.mesh_graph(*size, seed=seed)
    got = to_numpy(port)
    assert got["shape"] == tuple(int(s) for s in ref.shape) and got["vals"] is None and ref.vals is None
    np.testing.assert_array_equal(got["indptr"], np.asarray(ref.indptr))
    np.testing.assert_array_equal(got["indices"], np.asarray(ref.indices))
    assert port.indices.dtype == torch.int32


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_run_matrix_equals_the_reference_entry(name, port_entries, ref_entries):
    port = strip_times({name: port_entries[name]})[name]
    ref = strip_times({name: ref_entries[name]})[name]
    assert json.dumps(port) == json.dumps(ref)  # the same keys, in the same order, and values
    assert set(port["reorder"]) == {"degree", "rcm", "gray", "boba", "nested_dissection", "rabbit", "slashburn",
                                    "amd"}
    assert "fill" in port["natural"] and "hypergraph_k4" in port


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_time_fields_are_positive(name, port_entries):
    e = port_entries[name]
    assert e["convert_roundtrip_nnz_per_s"] > 0
    assert all(r["seconds"] >= 0 for r in e["reorder"].values()) and e["hypergraph_k4"]["seconds"] >= 0


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_to_markdown_equals_the_reference(name, port_entries, ref_entries):
    port = strip_times({name: port_entries[name]})
    md = suite.to_markdown(port)
    assert md == ref_suite.to_markdown(strip_times({name: ref_entries[name]}))
    assert md.startswith("# Benchmark suite results") and "| column-net |" in md


def test_ash958_graph_symmetrises_as_the_reference(tmp_path, monkeypatch):
    """The reference's recipe on a rectangular matrix (both readers pointed
    at the same file): mirrored, self-loops dropped, duplicates merged."""
    rng = np.random.default_rng(11)
    n, m = 40, 25
    keys = np.unique(rng.integers(0, n, 200) * m + rng.integers(0, m, 200))
    p = tmp_path / "rect.mtx"
    p.write_text(f"%%MatrixMarket matrix coordinate real general\n{n} {m} {len(keys)}\n"
                 + "".join(f"{k // m + 1} {k % m + 1} 1.0\n" for k in keys))
    read = RefIOBase.read_mtx_to_csr
    monkeypatch.setattr(RefIOBase, "read_mtx_to_csr", staticmethod(lambda _path, *a, **k: read(str(p), *a, **k)))
    port, ref = to_numpy(suite.ash958_graph(p, device="cpu")), ref_suite.ash958_graph()
    assert port["shape"] == (n, n)
    np.testing.assert_array_equal(port["indptr"], np.asarray(ref.indptr))
    np.testing.assert_array_equal(port["indices"], np.asarray(ref.indices))


def test_ash958_graph_raises_where_the_file_is_absent(tmp_path):
    with pytest.raises(OSError):
        suite.ash958_graph(tmp_path / "absent.mtx", device="cpu")


def test_ash958_graph_raises_without_a_path():
    """No default path: the port reads nothing outside its checkout unless told."""
    with pytest.raises(ValueError, match="--ash958 PATH"):
        suite.ash958_graph(device="cpu")


def test_ash958_asked_for_without_a_path_raises(capsys):
    with pytest.raises(ValueError, match="--ash958 PATH"):
        suite.main(["--json", "--device", "cpu", "--matrix", "ash958(sym)"])


@pytest.fixture
def small_suite(monkeypatch):
    """The port's three suite matrices replaced by small ones."""
    mesh = suite.mesh_graph
    monkeypatch.setattr(suite, "ash958_graph", lambda path, device: mesh(12, device=device))
    monkeypatch.setattr(suite, "synthetic_graph", lambda n, d, device: mesh(14, seed=1, device=device))
    monkeypatch.setattr(suite, "mesh_graph", lambda side, device: mesh(16, seed=2, device=device))


def test_main_json_on_the_cpu(small_suite, capsys):
    suite.main(["--json", "--device", "cpu", "--ash958", "ash958.mtx"])
    results = json.loads(capsys.readouterr().out)
    assert list(results) == ["ash958(sym)", "rand-20k", "mesh-90k(scrambled)"]
    assert [results[k]["n"] for k in results] == [144, 196, 256]
    assert all("hypergraph_k4" in e and "amd" in e["reorder"] for e in results.values())


def test_main_without_ash958_runs_the_synthetic_matrices(small_suite, capsys):
    suite.main(["--json", "--device", "cpu"])
    results = json.loads(capsys.readouterr().out)
    assert list(results) == ["rand-20k", "mesh-90k(scrambled)"]
    assert [results[k]["n"] for k in results] == [196, 256]


def test_main_writes_markdown(small_suite, tmp_path, capsys):
    out = tmp_path / "bench.md"
    suite.main(["--device", "cpu", "--out", str(out), "--ash958", "ash958.mtx"])
    assert capsys.readouterr().out.strip() == f"wrote {out}"
    md = out.read_text()
    assert md.count("## ") == 3 and "## mesh-90k(scrambled) — n=256" in md


def test_main_runs_the_matrices_asked_for(small_suite, capsys):
    suite.main(["--json", "--device", "cpu", "--matrix", "mesh-90k(scrambled)", "--matrix", "rand-20k"])
    results = json.loads(capsys.readouterr().out)
    assert list(results) == ["mesh-90k(scrambled)", "rand-20k"]
    assert [results[k]["n"] for k in results] == [256, 196]


def test_main_runs_on_the_card_by_default(small_suite):
    """Without ``--device`` the suite places its graphs on CUDA; with no card
    it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        suite.main(["--json"])
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            suite.main(["--json"])


# -- the distributed table -----------------------------------------------------------
DIST_GRAPHS = {  # the table's two matrices: one under the ring's 2,048-vertex gate, one over it
    "ash958(sym)": (lambda device: suite.synthetic_graph(1_000, 6, device=device),
                    lambda: ref_suite.synthetic_graph(1_000, 6)),
    "rand-20k": (lambda device: suite.mesh_graph(48, device=device), lambda: ref_suite.mesh_graph(48)),
}
DIST_TIME_FIELDS = ("rcm_host", "rcm_distributed", "slashburn_distributed_k32")


def strip_dist_times(results):
    out = copy.deepcopy(results)
    for name, e in out.items():
        if name != "devices":
            for field in DIST_TIME_FIELDS:
                e[field]["seconds"] = 0
    return out


@pytest.fixture
def small_dist(monkeypatch):
    """The port's distributed matrices replaced by ``DIST_GRAPHS``', its
    torch CPU ops on one thread (beside the suite's other workers more
    threads oversubscribe the cores and the mesh's many small passes slow
    down many-fold)."""
    port_ash, port_rand = (port for port, _ in DIST_GRAPHS.values())
    monkeypatch.setattr(suite, "ash958_graph", lambda path, device: port_ash(device))
    monkeypatch.setitem(suite.MATRICES, "rand-20k", port_rand)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref_dist():
    """The JAX table, from its own ``run_distributed`` on the 8 virtual
    devices, with ``ash958_graph`` and ``synthetic_graph`` patched."""
    ga, gb = (ref() for _, ref in DIST_GRAPHS.values())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_suite, "ash958_graph", lambda: ga)
        mp.setattr(ref_suite, "synthetic_graph", lambda *a, **k: gb)
        return ref_suite.run_distributed()


def test_run_distributed_equals_the_reference_table(small_dist, ref_dist):
    port = suite.run_distributed(device="cpu", shards=8, ash958="ash958.mtx")
    assert json.dumps(strip_dist_times(port)) == json.dumps(strip_dist_times(ref_dist))
    assert port["devices"] == 8 and list(port) == ["devices", "ash958(sym)", "rand-20k"]
    ring_entry = port["ash958(sym)"]["ring_mxu"]
    assert ring_entry["triangles"] > 0 and ring_entry["triangles_match_host"] and ring_entry["jaccard_match_host"]
    assert "ring_mxu" not in port["rand-20k"]  # 2,304 vertices: past the ring's gate
    assert all(port[name]["slashburn_distributed_k32"]["exact_host_parity"] for name in DIST_GRAPHS)
    assert all(port[name][field]["seconds"] >= 0 for name in DIST_GRAPHS for field in DIST_TIME_FIELDS)


def test_main_dist_prints_the_table(small_dist, capsys):
    suite.main(["--dist", "--device", "cpu", "--shards", "8", "--json"])
    table = json.loads(capsys.readouterr().out)
    assert table["devices"] == 8 and list(table) == ["devices", "rand-20k"]  # ash958 only with its path
    assert table["rand-20k"]["n"] == 2_304 and table["rand-20k"]["labelprop_distributed_k4"]["total_nnz"] > 0


def test_run_distributed_on_one_device_is_skipped_as_the_reference():
    """Without ``shards`` the table takes every device of its kind: one CPU
    is too few, as JAX's one device is."""
    assert suite.run_distributed(device="cpu") == {
        "skipped": "needs >=2 devices (set xla_force_host_platform_device_count)"}
