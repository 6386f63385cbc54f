"""Port parity for the HTML dashboard (``utils/visualizer.py``), on the CPU.

The port's ``to_html()`` must be the JAX package's string, character for
character, on the reference fixture matrix and on ``tests/golden/g960.mtx``
with the rcm, degree and gray orderings, with and without
``plot_edges_by_weights``, and so must the CLI's file. The ``|values|``
grid is a float64 sum in another order than ``np.add.at``'s; it is held to
the JAX grid at rtol 1e-12, and its printed form (``{v:g}``, six significant
digits, and a two-decimal opacity) cannot show a difference in the last
bits, so the HTML is compared exactly there too.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from sparsebase_tpu.bases import IOBase as RefIOBase  # noqa: E402
from sparsebase_tpu.bases import ReorderBase as RefReorderBase  # noqa: E402
from sparsebase_tpu.formats.csr import CSR as RefCSR  # noqa: E402
from sparsebase_tpu.utils import visualizer as ref_viz  # noqa: E402

import fixture as fx  # noqa: E402
from sparsebase_tpu_torch import CSR, IOBase, ReorderBase  # noqa: E402
from sparsebase_tpu_torch.interop import from_reference  # noqa: E402
from sparsebase_tpu_torch.utils import visualizer as viz  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
G960 = str(REPO / "tests" / "golden" / "g960.mtx")


def both(ref_csr, port_csr, **kw):
    return viz.Visualizer(port_csr, **kw), ref_viz.Visualizer(ref_csr, **kw)


def random_csr(n, m, nnz, seed):
    """A reference CSR with normal float32 values, and the port's copy."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, n, nnz) * m + rng.integers(0, m, nnz))
    row, col = keys // m, keys % m
    indptr = np.concatenate([[0], np.cumsum(np.bincount(row, minlength=n))]).astype(np.int32)
    vals = rng.standard_normal(len(keys)).astype(np.float32)
    ref = RefCSR.new(indptr, col.astype(np.int32), vals, shape=(n, m))
    return ref, from_reference(ref, "cpu")


@pytest.mark.parametrize("weights", [False, True], ids=["counts", "weights"])
def test_fixture_dashboard_equals_reference(weights):
    """The reference tests' dashboard: fx.make_csr, three buckets, a reversed
    ordering and two feature cards."""
    ref = fx.make_csr()
    port, want = both(ref, from_reference(ref, "cpu"), num_parts=3, title="t", plot_edges_by_weights=weights)
    for v in (port, want):
        v.add_ordering("rev", np.array([2, 1, 0], np.int32))
        v.add_features({"bandwidth": 3, "profile": 3})
    html = port.to_html()
    assert html == want.to_html()
    assert "<svg" in html and "rev" in html and "natural ordering" in html


@pytest.mark.parametrize("parts", [7, 32, 64])
@pytest.mark.parametrize("weights", [False, True], ids=["counts", "weights"])
def test_g960_dashboard_three_orderings_equals_reference(weights, parts):
    ref = RefIOBase.read_mtx_to_csr(G960)
    port_csr = IOBase.read_mtx_to_csr(G960, device="cpu")
    port, want = both(ref, port_csr, num_parts=parts, name="g960", plot_edges_by_weights=weights)
    for alias in ("rcm", "degree", "gray"):
        order = ReorderBase.reorder(alias, port_csr)
        np.testing.assert_array_equal(order.numpy(), np.asarray(RefReorderBase.reorder(alias, ref)))
        port.add_ordering(alias, order, features={"src": alias})
        want.add_ordering(alias, np.asarray(RefReorderBase.reorder(alias, ref)), features={"src": alias})
    port.add_features({"nnz": port_csr.nnz})
    want.add_features({"nnz": ref.nnz})
    html = port.to_html()
    assert html == want.to_html()
    assert html.count('class="section"') == 4
    for alias in ("rcm", "degree", "gray"):
        assert f"<h2>{alias}</h2>" in html
    assert "NNZ(s):" in html and "mean block bandwidth" in html


@pytest.mark.parametrize("shape", [(300, 300), (200, 350), (350, 200)], ids=["square", "wide", "tall"])
@pytest.mark.parametrize("weights", [False, True], ids=["counts", "weights"])
def test_real_valued_grids_and_html_equal_reference(shape, weights):
    """Normal float32 values, a row and a column ordering: the grid (counts
    exactly; weights at rtol 1e-12), the stats and the HTML."""
    n, m = shape
    ref, port_csr = random_csr(n, m, 4 * (n + m), seed=n + 7 * m)
    rng = np.random.default_rng(1)
    ro, co = rng.permutation(n).astype(np.int32), rng.permutation(m).astype(np.int32)
    port, want = both(ref, port_csr, num_parts=16, plot_edges_by_weights=weights)
    port.add_ordering("perm", torch.from_numpy(ro), torch.from_numpy(co))
    want.add_ordering("perm", ro, co)
    for orders in ((torch.arange(n, dtype=torch.int32), torch.arange(m, dtype=torch.int32)),
                   (torch.from_numpy(ro), torch.from_numpy(co))):
        grid, stats = port._density(*orders)
        ref_grid, ref_stats = want._density(*(o.numpy() for o in orders))
        assert grid.dtype == ref_grid.dtype
        if weights:
            np.testing.assert_allclose(grid, ref_grid, rtol=1e-12, atol=0)
        else:
            np.testing.assert_array_equal(grid, ref_grid)
        assert stats == pytest.approx(ref_stats, rel=1e-6)  # mean_bw: the JAX package sums in float32
        assert (stats["max_bw"], stats["num_full_blocks"]) == (ref_stats["max_bw"], ref_stats["num_full_blocks"])
    assert port.to_html() == want.to_html()


def test_orderings_stay_on_the_csr_device():
    ref = fx.make_csr()
    port = viz.Visualizer(from_reference(ref, "cpu"), num_parts=3)
    port.add_ordering("rev", np.array([2, 1, 0], np.int32))
    ro, co, extra = port._orderings["rev"]
    assert isinstance(ro, torch.Tensor) and ro.device.type == "cpu" and co is ro and extra == {}


def test_cli_writes_the_reference_report(tmp_path):
    """The CLI in a subprocess on g960 with ``--device cpu`` writes the JAX
    CLI's file and, with ``--trace``, a Chrome trace of the run."""
    args = [G960, "--orderings", "rcm,degree,gray", "--parts", "16", "--weights"]
    out, ref_out = tmp_path / "cli.html", tmp_path / "ref.html"
    r = subprocess.run([sys.executable, "-m", "sparsebase_tpu_torch.utils.visualizer", args[0], str(out), *args[1:],
                        "--device", "cpu", "--trace", str(tmp_path / "trace")],
                       capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "trace under" in r.stdout
    assert ref_viz._cli([args[0], str(ref_out), *args[1:]]) == 0
    assert out.read_text() == ref_out.read_text()
    trace = (tmp_path / "trace" / "visualizer" / "trace.json").read_text()
    assert '"visualizer"' in trace and "sbtorch:op:" in trace


def test_cli_reads_onto_the_card_by_default(tmp_path):
    """Without ``--device`` the CLI reads onto CUDA; with no card it raises
    instead of drawing the dashboard on the CPU."""
    out = tmp_path / "card.html"
    if torch.cuda.is_available():
        assert viz._cli([G960, str(out), "--orderings", "degree", "--parts", "8"]) == 0
        assert out.exists()
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            viz._cli([G960, str(out), "--orderings", "degree", "--parts", "8"])
        assert not out.exists()


def test_visualizer_takes_a_csr_where_it_is():
    """The dashboard does not copy its CSR to the host."""
    csr = CSR(torch.tensor([0, 1, 2]), torch.tensor([1, 0], dtype=torch.int32), torch.ones(2), (2, 2))
    assert viz.Visualizer(csr, num_parts=2).csr is csr
