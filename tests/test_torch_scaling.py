"""``parallel.scaling`` on the CPU against the JAX harness: the graphs, the
projection's arithmetic (``project_link`` given the JAX module's own link
figures as arguments equals ``project_ici``), and one sweep of rows, each
in its own process under a time limit, whose table keeps the JAX fields
and whose d = 2 row equals JAX ``run_one_row``'s size, entries, halo bytes
and BFS depth (JAX ``tests/test_parallel.py::TestWeakScaling``)."""

import copy
import json

import numpy as np
import pytest
import torch

from sparsebase_tpu_torch.parallel import scaling

jax = pytest.importorskip("jax")

from sparsebase_tpu.parallel import scaling as ref  # noqa: E402

ROW_TIME_LIMIT = 120  # seconds for each row's process; each takes a few
COUNTS = [1, 2, 4]
JAX_FIELDS = {"n", "nnz", "spmv_s", "rcm_s", "partition_s", "halo_path", "halo_bytes_per_step",
              "halo_bytes_per_device", "dense_bytes_per_device", "bfs_depth", "rcm_ml_s", "rcm_ml_steps",
              "spmv_efficiency", "rcm_efficiency", "partition_efficiency"}


@pytest.mark.parametrize("kind", ["random", "stencil"])
def test_make_graph_equals_jax(kind):
    got = scaling._make_graph(300, 4, seed=3, kind=kind, device="cpu")
    want = ref._make_graph(300, 4, seed=3, kind=kind)
    for name in ("indptr", "indices", "vals"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))


def table(with_ml: bool = True):
    """A made-up table of three rows, as the JAX harness returns it."""
    rows = {}
    for d, (spmv, rcm, part, depth, comm) in zip(COUNTS, [(1e-3, 0.2, 0.05, 12, 0), (1.3e-3, 0.31, 0.07, 14, 4096),
                                                          (2.1e-3, 0.52, 0.09, 17, 12288)]):
        rows[d] = {"spmv_s": spmv, "rcm_s": rcm, "partition_s": part, "bfs_depth": depth,
                   "halo_bytes_per_device": comm, "rcm_ml_s": 0.1 * d if with_ml else None, "rcm_ml_steps": 20 + d}
    return rows


@pytest.mark.parametrize("with_ml", [True, False])
def test_project_link_equals_jax_arithmetic(with_ml):
    got, want = table(with_ml), table(with_ml)
    scaling.project_link(got, COUNTS, ref.ICI_GB_S, ref.ICI_ALPHA_S)
    ref.project_ici(want, COUNTS)
    assert got == want


def test_project_link_takes_the_counted_rcm_steps():
    counted, fallback = table(), table()
    for d, r in counted.items():
        r["rcm_steps"] = ref.RCM_DEPTH_PASSES * r["bfs_depth"] + ref.RCM_RANK_ITERS
    scaling.project_link(counted, COUNTS, 50.0, 1e-5)
    scaling.project_link(fallback, COUNTS, 50.0, 1e-5)
    assert counted == {d: {**r, "rcm_steps": counted[d]["rcm_steps"]} for d, r in fallback.items()}
    counted[2]["rcm_steps"] *= 2
    scaling.project_link(counted, COUNTS, 50.0, 1e-5)
    assert counted[2]["rcm_projected_efficiency"] < fallback[2]["rcm_projected_efficiency"]


@pytest.fixture(scope="module")
def sweep():
    return scaling.run_weak_scaling(base_n=256, avg_deg=4, device_counts=COUNTS, reps=1, device="cpu",
                                    timeout=ROW_TIME_LIMIT)


def test_sweep_keeps_the_jax_fields(sweep):
    assert set(sweep) == set(COUNTS)
    for d, r in sweep.items():
        assert set(r) == JAX_FIELDS | {"devices", "rcm_steps", "setup_s", "row_s", "process_s"}
        assert 0 < r["setup_s"] < r["row_s"] < r["process_s"]
        assert r["n"] == 256 * d and r["spmv_s"] > 0 and r["devices"] == ["cpu"] * d
        assert r["rcm_steps"] >= r["bfs_depth"]
    assert sweep[1]["spmv_efficiency"] == 1.0


def test_row_equals_jax_run_one_row(sweep):
    want = ref.run_one_row("random", 2, base_n=256, avg_deg=4, reps=1)
    for name in ("n", "nnz", "halo_bytes_per_step", "halo_bytes_per_device", "dense_bytes_per_device", "bfs_depth"):
        assert sweep[2][name] == want[name], name


def test_main_writes_only_its_out_file(tmp_path, capsys):
    out = tmp_path / "scaling.json"
    scaling.main(["--device", "cpu", "--counts", "2", "--kinds", "stencil", "--base-n", "64", "--avg-deg", "4",
                  "--reps", "1", "--link-gb-s", "10", "--link-alpha-s", "1e-5", "--link-source", "a test's figures",
                  "--out", str(out)])
    printed = json.loads(capsys.readouterr().out)
    assert json.loads(out.read_text()) == printed
    assert printed["projection"]["source"] == "a test's figures" and printed["platform"] == "cpu"
    rows = printed["stencil"]
    for r in rows.values():
        assert r["bandwidth_rcm"] <= r["bandwidth_natural"] or r["bandwidth_rcm_ml"] <= r["bandwidth_natural"]
        assert "spmv_projected_efficiency" in r and "rcm_ml_projected_efficiency" in r


def test_main_projects_nothing_without_figures(monkeypatch, capsys):
    monkeypatch.setattr(scaling, "run_weak_scaling", lambda *a, **k: copy.deepcopy(table()))
    scaling.main(["--device", "cpu", "--kinds", "random"])
    printed = json.loads(capsys.readouterr().out)
    assert printed["projection"].startswith("none") and "spmv_projected_efficiency" not in printed["random"]["1"]


def test_a_failed_row_raises_with_its_stderr():
    if torch.cuda.is_available():
        pytest.skip("the row's failure here is a missing card")
    with pytest.raises(RuntimeError, match="row random d=1 failed:(.|\n)*no CUDA card"):
        scaling.run_weak_scaling(base_n=64, avg_deg=4, device_counts=[1], reps=1, device="cuda",
                                 timeout=ROW_TIME_LIMIT)
