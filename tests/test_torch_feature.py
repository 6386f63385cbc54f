"""Port parity for feature extraction (``ops/feature``), ``GraphFeatureBase``
and K6's plain version, on the CPU.

Every case of ``tests/test_feature.py`` runs through both packages, on the
same inputs made with numpy from a seed and carried across by
``interop.from_reference``. Integer features, ``DegreeDistribution``, Jaccard
weights and triangle counts must equal the JAX package's exactly, on every
tier (the JAX device routes run on JAX's CPU backend); the float64 column
statistics must agree within 1e-12 relative, because numpy and torch sum in
different orders. The goldens of ``tests/golden`` (written by the reference
library) hold the port on their own.
"""

import importlib
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import fixture as fx  # noqa: E402
import sparsebase_tpu as ref  # noqa: E402
import sparsebase_tpu.ops.feature as ref_feature  # noqa: E402
from sparsebase_tpu.bases import GraphFeatureBase as RefGraphFeatureBase  # noqa: E402
from sparsebase_tpu.ops.feature import fill as ref_fill  # noqa: E402
from sparsebase_tpu.ops.feature import jaccard as ref_jaccard  # noqa: E402
from sparsebase_tpu.ops.feature import sparse_common as ref_sparse  # noqa: E402
from sparsebase_tpu.ops.feature import triangles as ref_triangles  # noqa: E402

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import sparsebase_tpu_torch as sbt  # noqa: E402
import sparsebase_tpu_torch.ops.feature as feature  # noqa: E402
from sparsebase_tpu_torch import CSC, CSR, GraphFeatureBase, get_config, set_config  # noqa: E402
from sparsebase_tpu_torch.formats.array import DenseArray  # noqa: E402
from sparsebase_tpu_torch.interop import from_reference  # noqa: E402
from sparsebase_tpu_torch.ops.feature import fill, jaccard, sparse_common, triangles  # noqa: E402
from sparsebase_tpu_torch.ops.feature.structure import _balanced_starts, _block_of  # noqa: E402
from sparsebase_tpu_torch.ops.kernels import common_neighbors, common_neighbors_plain  # noqa: E402
from sparsebase_tpu_torch.utils.exceptions import FunctionNotFoundError, TypeMismatchError  # noqa: E402

# the module, which its function's name hides in ``ops.kernels``
cn_module = importlib.import_module("sparsebase_tpu_torch.ops.kernels.common_neighbors")

GOLDEN = Path(__file__).resolve().parent / "golden"
CPU = torch.device("cpu")


@pytest.fixture
def saved_config():
    saved = get_config()
    yield
    set_config(**{f: getattr(saved, f) for f in saved.__dataclass_fields__})


# -- graphs, made with numpy from a seed ---------------------------------------
def symmetric(r, c):
    return np.r_[r, c], np.r_[c, r]


def complete(n):
    r, c = np.nonzero(1 - np.eye(n, dtype=np.int8))
    return r, c, (n, n)


def rand_sym(seed, n, avg_deg, self_loops=False, dups=False):
    """The JAX tests' ``_rand_sym_csr`` graph, as (row, col, shape)."""
    rng = np.random.default_rng(seed)
    e = n * avg_deg // 2
    r, c = rng.integers(0, n, e), rng.integers(0, n, e)
    if not self_loops:
        keep = r != c
        r, c = r[keep], c[keep]
    r, c = symmetric(r, c)
    if dups:
        r, c = np.r_[r, r[: len(r) // 4]], np.r_[c, c[: len(c) // 4]]
    return r, c, (n, n)


def star_cross(n=300):
    """A star on vertex 0 plus the edge (1, 2): a hub of n - 1 and one triangle."""
    r = np.r_[np.zeros(n - 1, np.int64), np.arange(1, n), [1, 2]]
    c = np.r_[np.arange(1, n), np.zeros(n - 1, np.int64), [2, 1]]
    return r, c, (n, n)


def dense_graph(dense):
    r, c = np.nonzero(dense)
    return r, c, dense.shape


def k3_pendant():
    return dense_graph(np.array([[0, 1, 1, 0], [1, 0, 1, 0], [1, 1, 0, 1], [0, 0, 1, 0]]))


def random_dense(seed, n, p, sym=True, diag=False):
    rng = np.random.default_rng(seed)
    d = (rng.random((n, n)) < p).astype(np.int8)
    if not diag:
        np.fill_diagonal(d, 0)
    if sym:
        d = np.maximum(d, d.T)
    return dense_graph(d)


GRAPHS = {
    "fixture": lambda: (fx.ROWS, fx.COO_COLS, (fx.N, fx.N)),
    "k3-pendant": k3_pendant,
    "k4": lambda: complete(4),
    "path3": lambda: (np.array([0, 1, 1, 2]), np.array([1, 0, 2, 1]), (3, 3)),
    "cycle3-directed": lambda: (np.array([0, 1, 2]), np.array([1, 2, 0]), (3, 3)),
    "dups-loops": lambda: (np.array([0, 1, 1, 2, 0, 2, 0, 1, 1]), np.array([1, 0, 2, 1, 2, 0, 1, 0, 1]), (3, 3)),
    "empty": lambda: (np.zeros(0, np.int64), np.zeros(0, np.int64), (5, 5)),
    "star-cross": star_cross,
    "random30": lambda: random_dense(0, 30, 0.2),
    "random40-directed": lambda: random_dense(1, 40, 0.15, sym=False),
    "sym400": lambda: rand_sym(2, 400, 10),
    "sym400-loops-dups": lambda: rand_sym(3, 400, 10, self_loops=True, dups=True),
    "sym300-loops": lambda: rand_sym(4, 300, 12, self_loops=True),
    "empty-rows": lambda: (np.array([1, 1, 3, 3, 6]), np.array([3, 6, 1, 6, 1]), (8, 8)),
}
# column statistics also on an even column count and an empty column
COLUMN_GRAPHS = {
    **{k: GRAPHS[k] for k in ("fixture", "k4", "dups-loops", "random30", "sym400-loops-dups")},
    "even-cols": lambda: (np.array([0, 0, 1, 2, 3, 3, 3]), np.array([0, 1, 1, 3, 0, 1, 2]), (4, 4)),
    "empty-column": lambda: (np.array([0, 1, 2, 2]), np.array([0, 0, 2, 3]), (3, 4)),
    "rectangular": lambda: (np.array([0, 0, 1, 4, 4]), np.array([0, 6, 2, 2, 5]), (5, 7)),
}


def ref_csr(name, graphs=GRAPHS):
    r, c, shape = graphs[name]()
    coo = ref.COO.new(np.asarray(r, np.int32), np.asarray(c, np.int32), None, shape=shape, sort=True)
    return coo.convert(ref.CSR)


def port(fmt):
    return from_reference(fmt, CPU)


def same_int(got, want):
    assert int(got) == int(np.asarray(want))


def same_array(got, want):
    got = got.vals if isinstance(got, DenseArray) else got
    want = np.asarray(want.vals if hasattr(want, "vals") else want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


# -- row and structure features: exact ------------------------------------------
INT_FEATURES = ["MinDegree", "MaxDegree", "Bandwidth", "Profile"]


@pytest.mark.parametrize("graph", sorted(set(GRAPHS) - {"empty"}))
@pytest.mark.parametrize("name", INT_FEATURES)
def test_integer_features_equal_jax(name, graph):
    g = ref_csr(graph)
    same_int(getattr(feature, name)().execute(None, port(g)), getattr(ref_feature, name)().execute(None, g))


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_degrees_and_distribution_equal_jax(graph):
    g = ref_csr(graph)
    deg = feature.Degrees().get_degrees(port(g))
    assert deg.dtype == torch.int32
    same_array(deg, ref_feature.Degrees().get_degrees(g))
    dist = feature.DegreeDistribution().get_distribution(port(g))
    assert dist.dtype == torch.float32
    same_array(dist, ref_feature.DegreeDistribution().get_distribution(g))  # bit for bit
    dist64 = feature.DegreeDistribution(torch.float64).get_distribution(port(g))
    same_array(dist64, ref_feature.DegreeDistribution(np.float64).get_distribution(g))
    avg = feature.AvgDegree().execute(None, port(g))
    assert isinstance(avg, float) and avg == ref_feature.AvgDegree().execute(None, g)


def test_bandwidth_of_no_entries_is_the_int_zero():
    g = ref_csr("empty")
    assert feature.Bandwidth().get_bandwidth(port(g)) == 0 == ref_feature.Bandwidth().get_bandwidth(g)
    same_int(feature.Profile().get_profile(port(g)), 0)


@pytest.mark.parametrize("hw", [(2, 2), (1, 1), (3, 3), (2, 3), (3, 2), (1, 4), (7, 7), (9, 4), (4, 9), (50, 50)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("graph", ["fixture", "random30", "empty-rows", "sym400"])
def test_off_diag_block_nnz_equals_jax(graph, hw):
    """h = w, h != w, and more blocks than rows (q == 0 in the closed form)."""
    g = ref_csr(graph)
    same_int(feature.OffDiagBlockNNZ(*hw).get_off_diag_block_nnz(port(g)),
             ref_feature.OffDiagBlockNNZ(*hw).get_off_diag_block_nnz(g))


@pytest.mark.parametrize("total", [0, 1, 2, 5, 7, 16, 100])
@pytest.mark.parametrize("parts", [1, 2, 3, 7, 16, 150])
def test_block_of_is_the_search_of_balanced_starts(total, parts):
    starts = _balanced_starts(total, parts, CPU)
    i = torch.arange(total)
    want = np.searchsorted(starts.numpy(), i.numpy(), side="right") - 1
    np.testing.assert_array_equal(_block_of(i, total, parts).numpy(), want)


# -- column features: float64 within 1e-12 relative --------------------------------
COLUMN_INT = ["MinDegreeColumn", "MaxDegreeColumn"]
COLUMN_FLOAT = ["AvgDegreeColumn", "MedianDegreeColumn", "StandardDeviationDegreeColumn",
                "CoefficientOfVariationDegreeColumn", "GeometricAvgDegreeColumn"]


@pytest.mark.parametrize("source", ["csc", "csr"])
@pytest.mark.parametrize("graph", sorted(COLUMN_GRAPHS))
@pytest.mark.parametrize("name", COLUMN_INT + COLUMN_FLOAT)
def test_column_features_equal_jax(name, graph, source):
    """On a CSC, and on a CSR that converts through ``csr_to_csc``."""
    g = ref_csr(graph, COLUMN_GRAPHS)
    g_in = g.convert(ref.CSC) if source == "csc" else g
    want = np.asarray(getattr(ref_feature, name)().execute(None, g_in))
    got = getattr(feature, name)().execute(None, port(g_in))
    got = float(got) if isinstance(got, float) else got
    if name in COLUMN_INT:
        assert int(got) == int(want)
        return
    if isinstance(got, torch.Tensor):
        assert got.dtype == torch.float64 and got.dim() == 0
    got, want = float(got), float(want)
    if np.isfinite(want):
        assert got == pytest.approx(want, rel=1e-12, abs=0)
    else:
        assert got == want


def test_median_averages_the_middle_two_and_geometric_mean_of_an_empty_column():
    even = port(ref_csr("even-cols", COLUMN_GRAPHS)).convert(CSC)  # column degrees 2, 3, 1, 1
    assert float(feature.MedianDegreeColumn().execute(None, even)) == 1.5
    empty_col = port(ref_csr("empty-column", COLUMN_GRAPHS))  # column 1 holds nothing
    assert float(feature.GeometricAvgDegreeColumn().execute(None, empty_col)) == 0.0  # exp(-inf)
    assert float(ref_feature.GeometricAvgDegreeColumn().execute(None, ref_csr("empty-column", COLUMN_GRAPHS))) == 0.0


# -- the cases of tests/test_feature.py, through both packages ------------------------
def test_fixture_row_features():
    csr, coo = port(fx.make_csr()), port(fx.make_coo())
    np.testing.assert_array_equal(feature.Degrees().get_degrees(csr).numpy(), fx.DEGREES)
    np.testing.assert_array_equal(feature.Degrees().get_degrees(coo).numpy(), fx.DEGREES)  # auto-convert
    np.testing.assert_array_equal(feature.DegreeDistribution().get_distribution(csr).numpy(), fx.DISTRIBUTION)
    assert int(feature.MinDegree().execute(None, csr)) == 1
    assert int(feature.MaxDegree().execute(None, csr)) == 2
    assert feature.AvgDegree().execute(None, csr) == pytest.approx(4 / 3)


def test_fixture_column_features():
    csc = port(fx.make_csc())
    d, avg = np.array([2, 1, 1]), 4 / 3
    assert int(feature.MinDegreeColumn().execute(None, csc)) == 1
    assert int(feature.MaxDegreeColumn().execute(None, csc)) == 2
    assert int(feature.MaxDegreeColumn().execute(None, port(fx.make_csr()))) == 2
    assert float(feature.MedianDegreeColumn().execute(None, csc)) == 1.0
    std = np.sqrt(((d - avg) ** 2).sum())
    assert float(feature.StandardDeviationDegreeColumn().execute(None, csc)) == pytest.approx(std, rel=1e-12)
    assert float(feature.CoefficientOfVariationDegreeColumn().execute(None, csc)) == pytest.approx(std / avg, rel=1e-12)
    assert float(feature.GeometricAvgDegreeColumn().execute(None, csc)) == pytest.approx(
        np.exp(np.log(d).sum() / 3), rel=1e-12)


def test_fixture_structure():
    csr = port(fx.make_csr())
    assert int(feature.Bandwidth().get_bandwidth(csr)) == 3
    assert int(feature.Profile().get_profile(csr)) == 3
    assert int(feature.OffDiagBlockNNZ(2, 2).get_off_diag_block_nnz(csr)) == 2
    assert int(feature.OffDiagBlockNNZ(1, 1).get_off_diag_block_nnz(csr)) == 0


@pytest.mark.parametrize("graph,directed,want", [
    ("k3-pendant", False, 1), ("k4", False, 4), ("path3", False, 0), ("cycle3-directed", True, 1),
    ("cycle3-directed", False, 0), ("dups-loops", False, 1), ("star-cross", False, 1), ("empty", False, 0),
])
@pytest.mark.parametrize("use_graphkit", [True, False], ids=["graphkit", "torch"])
def test_triangle_count_cases(saved_config, graph, directed, want, use_graphkit):
    set_config(use_graphkit=use_graphkit)
    g = ref_csr(graph)
    got = feature.TriangleCount(directed).get_triangle_count(port(g))
    assert isinstance(got, int) and got == want == ref_feature.TriangleCount(directed).get_triangle_count(g)


def test_triangle_count_random_against_trace():
    r, c, shape = GRAPHS["random30"]()
    dense = np.zeros(shape, np.int64)
    dense[r, c] = 1
    assert feature.TriangleCount().get_triangle_count(port(ref_csr("random30"))) == np.trace(dense @ dense @ dense) // 6


def test_jaccard_fixture_values():
    g = port(ref_csr("k3-pendant"))
    w = feature.JaccardWeights().get_jaccard_weights(g).vals.numpy()
    row, col = g.row_of_nnz().numpy(), g.indices.numpy()
    assert w[np.nonzero((row == 0) & (col == 1))[0][0]] == pytest.approx(1 / 3)
    assert w[np.nonzero((row == 2) & (col == 3))[0][0]] == 0.0
    sym = port(ref_csr("random30"))
    w = feature.JaccardWeights().get_jaccard_weights(sym).vals.numpy()
    lookup = {(int(a), int(b)): x for a, b, x in zip(sym.row_of_nnz().numpy(), sym.indices.numpy(), w)}
    assert all(lookup[(b, a)] == x for (a, b), x in lookup.items())


# -- Jaccard: bit for bit against every JAX tier ----------------------------------
JACCARD_GRAPHS = sorted(set(GRAPHS) - {"fixture"})


@pytest.mark.parametrize("graph", JACCARD_GRAPHS)
def test_jaccard_equals_every_jax_tier(saved_config, graph):
    g = ref_csr(graph)
    want = np.asarray(ref_jaccard._jaccard_host(g))
    if g.nnz:
        np.testing.assert_array_equal(np.asarray(ref_jaccard._jaccard_device(g.to_device())), want)
    np.testing.assert_array_equal(np.asarray(ref_sparse.jaccard_weights_sparse_device(g.to_device())), want)
    p = port(g)
    same_array(jaccard._jaccard_host(p), want)
    same_array(sparse_common.jaccard_weights_sparse_device(p), want)
    with mock.patch.object(cn_module, "PLAIN_CHUNK_SLOTS", 7):  # many chunks
        same_array(common_neighbors_plain(p, "jaccard"), want)
    for use_graphkit in (True, False):
        set_config(use_graphkit=use_graphkit)
        out = feature.JaccardWeights().get_jaccard_weights(p)
        assert isinstance(out, DenseArray) and out.vals.dtype == torch.float32
        same_array(out, want)


# -- triangles: exact on every tier -------------------------------------------------
TRIANGLE_GRAPHS = ["dups-loops", "k3-pendant", "k4", "star-cross", "empty", "random30", "random40-directed",
                   "sym400", "sym400-loops-dups", "sym300-loops", "empty-rows", "k64"]


def tri_graph(name):
    if name == "k64":
        r, c, shape = complete(64)
        return ref.COO.new(r.astype(np.int32), c.astype(np.int32), None, shape=shape).convert(ref.CSR)
    return ref_csr(name)


def ref_without_loops(g):
    """The JAX CSR's pattern with its diagonal entries dropped."""
    indptr, cols = np.asarray(g.indptr), np.asarray(g.indices)
    rows = np.repeat(np.arange(g.shape[0]), np.diff(indptr))
    off = rows != cols
    return ref.COO.new(rows[off].astype(np.int32), cols[off].astype(np.int32), None, shape=g.shape,
                       sort=True).convert(ref.CSR)


@pytest.mark.parametrize("graph", TRIANGLE_GRAPHS)
def test_triangle_tiers_equal_jax(graph):
    """Every tier equals its JAX counterpart; the directed host route equals
    the JAX one on the pattern without self-loops, which every route of the
    port ignores (the JAX host route counts u -> v -> v -> u through one)."""
    g = tri_graph(graph)
    p = port(g)
    und, dirc = ref_triangles._undirected_count(g), ref_triangles._directed_count(ref_without_loops(g))
    assert triangles._undirected_count(p) == und
    assert triangles._directed_count(p) == dirc
    dense = p.to_dense() != 0
    symmetric = torch.equal(dense, dense.T)
    for directed, host in ((False, und), (True, dirc)):
        want = ref_triangles._device_dense_count(g.to_device(), directed) if g.nnz else 0
        assert triangles._device_dense_count(p, directed) == want
        # across tiers, in both packages: the undirected tiers agree on a
        # symmetric pattern, the directed ones on every pattern
        if directed or symmetric:
            assert want == host
    assert sparse_common.triangle_count_sparse_device(p) == ref_sparse.triangle_count_sparse_device(g.to_device())
    if symmetric:
        assert sparse_common.triangle_count_sparse_device(p) == und
    assert sparse_common.directed_triangle_count_sparse_device(p) == dirc
    csc = p.convert(CSC)
    for mode in ("triangles", "directed"):
        whole = int(common_neighbors_plain(p, mode, csc))
        with mock.patch.object(cn_module, "PLAIN_CHUNK_SLOTS", 5):  # many chunks
            assert int(common_neighbors_plain(p, mode, csc)) == whole


@pytest.mark.parametrize("use_graphkit", [True, False], ids=["graphkit", "torch"])
def test_directed_count_ignores_self_loops(saved_config, use_graphkit):
    """0 -> 1 -> 0 with a self-loop at 1, and the 3-cycle 2 -> 3 -> 4 -> 2:
    one directed 3-cycle on every route of the port, as the JAX dense tier
    counts; the JAX host route also counts 0 -> 1 -> 1 -> 0."""
    set_config(use_graphkit=use_graphkit)
    g = ref_csr("loop-2cycle", {"loop-2cycle": lambda: (np.array([0, 1, 1, 2, 3, 4]), np.array([1, 0, 1, 3, 4, 2]),
                                                        (5, 5))})
    p = port(g)
    assert ref_triangles._device_dense_count(g.to_device(), True) == 1
    assert ref_triangles._directed_count(g) == 2
    assert feature.TriangleCount(True).get_triangle_count(p) == 1
    assert triangles._directed_count(p) == triangles._device_dense_count(p, True) == 1
    assert sparse_common.directed_triangle_count_sparse_device(p) == 1


def test_triangle_tiers_on_k512_past_the_float32_range(monkeypatch):
    """K_512: 6T = 133,432,320 > 2^24; every tier stays exact."""
    n = 512
    want = n * (n - 1) * (n - 2) // 6  # C(512, 3)
    r, c, shape = complete(n)
    g = ref.COO.new(r.astype(np.int32), c.astype(np.int32), None, shape=shape).convert(ref.CSR)
    p = port(g)
    monkeypatch.setattr(cn_module, "PLAIN_CHUNK_SLOTS", 1 << 22)  # about 0.3 GB of temporaries at a time
    assert ref_triangles._device_dense_count(g.to_device(), False) == want
    assert triangles._device_dense_count(p, False) == want
    assert triangles._device_dense_count(p, True) == 2 * want
    assert triangles._undirected_count(p) == want
    assert sparse_common.triangle_count_sparse_device(p) == want
    assert feature.TriangleCount().get_triangle_count(p) == want


def test_sparse_tier_rejects_directed():
    with pytest.raises(ValueError):
        sparse_common.triangle_count_sparse_device(port(ref_csr("k4")), directed=True)


def on_meta(csr):
    """The CSR's pattern on the ``meta`` device: a tensor that is not on the
    CPU, which takes the routes of a CUDA CSR without a card."""
    return CSR(csr.indptr.to("meta"), csr.indices.to("meta"), None, csr.shape)


@pytest.mark.parametrize("directed,n,route", [(False, 400, "k6"), (False, 20_000, "k6"), (True, 400, "dense"),
                                              (True, 16_384, "dense"), (True, 16_385, "k6-directed"),
                                              (True, 20_000, "k6-directed")])
def test_triangle_count_routes_off_the_cpu(monkeypatch, directed, n, route):
    """Off the CPU: K6 undirected at every n; directed, the dense tier up to
    ``MAX_DEVICE_DENSE_N`` and K6's directed mode past it; never the host."""
    calls = []
    monkeypatch.setattr(sparse_common, "triangle_count_sparse_device", lambda csr: calls.append("k6") or -1)
    monkeypatch.setattr(sparse_common, "directed_triangle_count_sparse_device",
                        lambda csr: calls.append("k6-directed") or -1)
    monkeypatch.setattr(triangles, "_device_dense_count", lambda csr, d: calls.append("dense") or -1)
    monkeypatch.setattr(CSR, "to_host", lambda self: calls.append("host") or self)
    host = port(ref_csr("sym400"))
    # the same entries with empty rows added past the dense wall
    big = host if n == 400 else CSR(torch.cat([host.indptr, host.indptr[-1:].expand(n - 400)]), host.indices, None,
                                    (n, n))
    assert feature.TriangleCount(directed).get_triangle_count(on_meta(big)) == -1
    assert calls == [route]


def test_jaccard_routes_off_the_cpu_to_k6(monkeypatch):
    calls = []
    monkeypatch.setattr(sparse_common, "jaccard_weights_sparse_device",
                        lambda csr: calls.append("k6") or torch.zeros(csr.nnz))
    out = feature.JaccardWeights().get_jaccard_weights(on_meta(port(ref_csr("sym400"))))
    assert calls == ["k6"] and isinstance(out, DenseArray)


def more_columns_than_rows(n: int) -> CSR:
    """``n`` rows and ``n + 2`` columns; ids ``n`` and ``n + 1`` name no row."""
    indptr = torch.tensor([0, 2, 3] + [4] * (n - 1))
    return CSR(indptr, torch.tensor([0, n, n + 1, 1], dtype=torch.int32), None, (n, n + 2))


@pytest.mark.parametrize("device,n", [("cpu", 3), ("meta", 3), ("meta", 16_385)])
@pytest.mark.parametrize("use_graphkit", [True, False], ids=["graphkit", "torch"])
@pytest.mark.parametrize("op", ["jaccard", "triangles", "directed"])
def test_more_columns_than_rows_raises_on_every_route(saved_config, op, use_graphkit, device, n):
    """A column id that names no row raises before any route: on the CPU
    with graphkit on (which read past ``indptr``) and off, and on the routes
    of a CUDA CSR on both sides of the dense wall. Not held to the JAX
    package, which reads undefined memory there."""
    set_config(use_graphkit=use_graphkit)
    csr = more_columns_than_rows(n)
    csr = csr if device == "cpu" else on_meta(csr)
    with pytest.raises(ValueError, match="more columns than rows"):
        if op == "jaccard":
            feature.JaccardWeights().get_jaccard_weights(csr)
        else:
            feature.TriangleCount(op == "directed").get_triangle_count(csr)


def test_k6_wrapper_raises_off_the_cpu_without_a_card():
    """Tensors that are not on the CPU launch the kernel or raise: never the
    plain version."""
    k4 = port(ref_csr("k4"))
    p, csc = on_meta(k4), k4.convert(CSC)
    csc = CSC(csc.indptr.to("meta"), csc.indices.to("meta"), None, csc.shape)
    for mode in ("jaccard", "triangles", "directed"):
        with pytest.raises(TypeMismatchError):
            common_neighbors(p, mode, csc)


# -- K6's plain version against a brute-force set count ------------------------------
def brute_counts(r, c, n):
    """K6's three results by Python sets: the Jaccard weights, the triangle
    sum, and the directed 3-cycles u -> v -> w -> u anchored at u."""
    rows = [list(c[r == i]) for i in range(n)]
    w, tri = [], 0
    for e, (u, v) in enumerate(zip(r, c)):
        nv = set(rows[v])
        inter = sum(1 for x in rows[u] if x in nv)
        w.append(np.float32(inter / max(len(rows[u]) + len(rows[v]) - inter, 1)))
        if u != v and not (e > 0 and r[e - 1] == u and c[e - 1] == v):
            tri += len((set(rows[u]) & nv) - {u, v})
    edges = set(zip(r.tolist(), c.tolist()))
    cycles = sum(1 for u, v in edges for x in set(rows[v]) if u < v and x > u and x != v and (x, u) in edges)
    return np.array(w, np.float32), tri, cycles


@settings(max_examples=80, deadline=None)
@given(n=st.integers(1, 12), data=st.data())
def test_common_neighbors_plain_against_brute_force(n, data):
    pairs = data.draw(st.lists(st.tuples(st.integers(0, n - 1), st.integers(0, n - 1)), max_size=60))
    if data.draw(st.booleans()):
        pairs = pairs + [(b, a) for a, b in pairs]
    r = np.array([a for a, _ in pairs], np.int64)
    c = np.array([b for _, b in pairs], np.int64)
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    indptr = np.r_[0, np.cumsum(np.bincount(r, minlength=n))]
    csr = CSR(torch.from_numpy(indptr), torch.from_numpy(c.astype(np.int32)), None, (n, n))
    csc = csr.convert(CSC)
    w, tri, cycles = brute_counts(r, c, n)
    with mock.patch.object(cn_module, "PLAIN_CHUNK_SLOTS", data.draw(st.sampled_from([1, 3, 1 << 26]))):
        np.testing.assert_array_equal(common_neighbors_plain(csr, "jaccard").numpy(), w)
        assert int(common_neighbors_plain(csr, "triangles")) == tri
        assert int(common_neighbors_plain(csr, "directed", csc)) == cycles
    assert torch.equal(common_neighbors(csr, "jaccard"), common_neighbors_plain(csr, "jaccard"))
    assert int(common_neighbors(csr, "directed", csc)) == cycles


def test_common_neighbors_checks_its_input():
    p = port(ref_csr("k4"))
    with pytest.raises(ValueError):
        common_neighbors(p, "cosine")
    wide = CSR(p.indptr, p.indices, None, (4, 9))
    with pytest.raises(ValueError):
        common_neighbors_plain(wide, "jaccard")
    with pytest.raises(ValueError):  # directed mode needs the CSC
        common_neighbors(p, "directed")
    tall = CSR(torch.cat([p.indptr, p.indptr[-1:]]), p.indices, None, (5, 4))
    with pytest.raises(ValueError):  # and a square matrix
        common_neighbors_plain(tall, "directed", tall.convert(CSC))
    empty = port(ref_csr("empty"))
    assert common_neighbors(empty, "jaccard").shape == (0,)
    assert int(common_neighbors(empty, "triangles")) == 0 and common_neighbors(empty, "triangles").dim() == 0


# -- FillIn ----------------------------------------------------------------------
def band(n, half):
    i = np.arange(n)[:, None] + np.arange(-half, half + 1)[None, :]
    r = np.repeat(np.arange(n), 2 * half + 1).reshape(n, -1)
    keep = (i >= 0) & (i < n)
    return r[keep], i[keep], (n, n)


FILL_GRAPHS = {"sym400": GRAPHS["sym400"], "sym400-loops-dups": GRAPHS["sym400-loops-dups"],
               "random40-directed": GRAPHS["random40-directed"], "band": lambda: band(300, 4),
               "empty": GRAPHS["empty"], "fixture": GRAPHS["fixture"]}


@pytest.mark.parametrize("graph", sorted(FILL_GRAPHS))
def test_fill_in_equals_jax(saved_config, graph):
    g = ref_csr(graph, FILL_GRAPHS)
    want = ref_feature.FillIn().get_fill(g)
    ip, ix = np.asarray(g.indptr).astype(np.int64), np.asarray(g.indices).astype(np.int64)
    assert ref_fill._fill_nnz_host(ip, ix, g.nrows) == want
    p = port(g)
    assert fill._fill_nnz_host(p.indptr, p.indices.to(torch.int64), p.nrows) == want
    for use_graphkit in (True, False):
        set_config(use_graphkit=use_graphkit)
        got = feature.FillIn().get_fill(p)
        assert isinstance(got, int) and got == want
    if graph == "band":  # no fill inside a band: row i of L holds min(i, 4) + 1 entries
        assert want == sum(min(i, 4) + 1 for i in range(300))


# -- fused extraction and the façade -----------------------------------------------
def test_fused_features():
    csr = port(fx.make_csr())
    out = feature.DegreesDegreeDistribution().extract(csr)
    np.testing.assert_array_equal(out[feature.Degrees].numpy(), fx.DEGREES)
    np.testing.assert_array_equal(out[feature.DegreeDistribution].numpy(), fx.DISTRIBUTION)
    out = feature.MinMaxAvgDegree().extract(csr)
    assert set(out) == {feature.MinDegree, feature.MaxDegree, feature.AvgDegree}
    assert int(out[feature.MinDegree]) == 1 and int(out[feature.MaxDegree]) == 2


def test_extractor_fuses_and_filters():
    ex = feature.FeatureExtractor()
    calls = []
    orig = feature.DegreesDegreeDistribution._impl
    feature.DegreesDegreeDistribution._impl = staticmethod(lambda f, p: calls.append(1) or orig(f, p))
    try:
        out = ex.extract(port(fx.make_csr()), features=[feature.Degrees, feature.DegreeDistribution])
    finally:
        feature.DegreesDegreeDistribution._impl = staticmethod(orig)
    assert set(out) == {feature.Degrees, feature.DegreeDistribution} and calls == [1]  # one fused pass
    np.testing.assert_array_equal(out[feature.Degrees].numpy(), fx.DEGREES)
    out = ex.extract(port(fx.make_csr()), features=[feature.Bandwidth, feature.MinDegree, feature.MaxDegree,
                                                      feature.AvgDegree])
    assert set(out) == {feature.Bandwidth, feature.MinDegree, feature.MaxDegree, feature.AvgDegree}
    assert int(out[feature.Bandwidth]) == 3 and int(out[feature.MinDegree]) == 1
    out = ex.extract(port(fx.make_csr()), features=[feature.MinDegree])
    assert set(out) == {feature.MinDegree}  # the fused triple ran; only what was asked comes back


def test_extractor_add_subtract_and_unregistered():
    ex = feature.FeatureExtractor()
    d = feature.Degrees()
    ex.add(d)
    assert ex.get_list() == [feature.Degrees]
    out = ex.extract(port(fx.make_csr()))
    assert set(out) == {feature.Degrees}
    ex.subtract(d)
    assert ex.get_list() == []
    ex.add(feature.MinMaxAvgDegree())
    assert ex.get_list() == [feature.AvgDegree, feature.MaxDegree, feature.MinDegree]
    with pytest.raises(FunctionNotFoundError):
        feature.Extractor().extract(port(fx.make_csr()), features=[feature.Degrees])


def test_reference_features_extract_equal_jax():
    """All 19 reference features in one fused call, both packages."""
    g = ref_csr("sym400-loops-dups")
    # a fused class is no feature of its own: its sub-features are asked for,
    # and the extractor fuses them again (a fused class asked for raises in both)
    with pytest.raises(FunctionNotFoundError):
        GraphFeatureBase.extract([feature.MinMaxAvgDegree], port(g))
    leaves = [c for c in feature.REFERENCE_FEATURES if not issubclass(c, feature.FusedFeature)]
    assert len(leaves) == 17
    want = ref_feature.FeatureExtractor().extract(
        g, features=[c for c in ref_feature.REFERENCE_FEATURES if not issubclass(c, ref_feature.FusedFeature)])
    got = GraphFeatureBase.extract(leaves, port(g))
    assert [c.__name__ for c in got] and {c.__name__ for c in got} == {c.__name__ for c in want}
    names = {c.__name__: c for c in want}
    for cls, value in got.items():
        ref_value = want[names[cls.__name__]]
        if isinstance(value, DenseArray):
            same_array(value, ref_value)
        elif cls.__name__ in COLUMN_FLOAT:
            assert float(value) == pytest.approx(float(np.asarray(ref_value)), rel=1e-12, abs=0)
        elif isinstance(value, torch.Tensor) and value.is_floating_point():
            same_array(value.reshape(-1), np.asarray(ref_value).reshape(-1))
        else:
            assert np.asarray(value).tolist() == np.asarray(ref_value).tolist(), cls.__name__


def test_graph_feature_base_facade():
    csr, coo = port(fx.make_csr()), port(fx.make_coo())
    np.testing.assert_array_equal(GraphFeatureBase.get_degrees(csr).numpy(), fx.DEGREES)
    np.testing.assert_array_equal(GraphFeatureBase.get_degree_distribution(coo).numpy(), fx.DISTRIBUTION)
    converted, deg = GraphFeatureBase.get_degrees_cached(coo)
    assert isinstance(converted[0], CSR) and torch.equal(deg, torch.from_numpy(fx.DEGREES))
    out = GraphFeatureBase.extract([feature.Degrees, feature.Bandwidth], coo)
    assert set(out) == {feature.Degrees, feature.Bandwidth}
    g = ref_csr("sym400")
    assert GraphFeatureBase.get_fill_in(port(g)) == RefGraphFeatureBase.get_fill_in(g)
    assert sbt.GraphFeatureBase is GraphFeatureBase


def test_exports():
    assert len(feature.ALL_FEATURES) == 20 and feature.REFERENCE_FEATURES == feature.ALL_FEATURES[:-1]
    assert [c.__name__ for c in feature.ALL_FEATURES] == [c.__name__ for c in ref_feature.ALL_FEATURES]
    assert set(ref_feature.__all__) <= set(feature.__all__)
    assert {"Feature", "FusedFeature", "Extractor", "FeatureExtractor"} <= set(feature.__all__)


# -- the reference library's goldens -----------------------------------------------
def golden_csr(name):
    return sbt.IOBase.read_mtx_to_csr(str(GOLDEN / f"{name}.mtx"), device="cpu")


@pytest.mark.parametrize("name", ["g960", "ash958_sym"])
def test_goldens_degrees_and_scalars(name):
    csr = golden_csr(name)
    np.testing.assert_array_equal(feature.Degrees().get_degrees(csr).numpy(),
                                  np.loadtxt(GOLDEN / name / "degrees.txt", dtype=np.int64))
    scalars = dict(line.split() for line in (GOLDEN / name / "scalars.txt").read_text().splitlines())
    assert int(feature.Bandwidth().get_bandwidth(csr)) == int(scalars["bandwidth"])
    assert int(feature.Profile().get_profile(csr)) == int(scalars["profile"])


def test_g960_features_and_distribution():
    csr = golden_csr("g960")
    dist = feature.DegreeDistribution(torch.float64).get_distribution(csr).numpy()
    np.testing.assert_array_equal(dist, np.loadtxt(GOLDEN / "g960" / "degree_distribution.txt"))
    feats = dict(line.split() for line in (GOLDEN / "g960" / "features.txt").read_text().splitlines())
    out = GraphFeatureBase.extract([feature.MinDegree, feature.MaxDegree, feature.AvgDegree, feature.TriangleCount],
                                   csr)
    assert int(out[feature.MinDegree]) == int(feats["min_degree"])
    assert int(out[feature.MaxDegree]) == int(feats["max_degree"])
    assert out[feature.AvgDegree] == pytest.approx(float(feats["avg_degree"]), rel=1e-15)
    # the reference's undirected count tests a stale marker for truthiness
    # (triangle_count.cc:190-199), so its golden is wrong; the trace is right
    dense = csr.to_dense().to(torch.int64) != 0
    d = dense.to(torch.int64)
    oracle = int(torch.trace(d @ d @ d)) // 6
    assert out[feature.TriangleCount] == oracle != int(feats["triangles_undirected"])
