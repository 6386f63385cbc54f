"""Port parity for the reorderers (``ops/reorder/{gray,boba,heatmap,generic,
slashburn,amd,nested_dissection,rabbit}.py``) and ``ReorderBase``, on the CPU.

Every reorderer must equal the JAX package exactly on the same input: Gray on
both JAX routes (numpy arrays and jnp arrays on the CPU), each host reorderer
with graphkit on and with it off in both packages. The only tolerance is the
heatmap's ``mean_bw``, rtol 1e-6: the port sums the bandwidths exactly in
int64, the JAX package in float32. The reference library's goldens
(``tests/golden/``) are held as ``tests/test_parity.py`` holds the JAX
package: Gray (g960) and BOBA exactly, the heatmap grids within 1.5e-6,
SlashBurn by its per-round hub sets and its round-0 hub degrees. Inputs are
numpy arrays from a seed; every JAX call runs on the CPU.
"""

import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import sparsebase_tpu as ref  # noqa: E402
import sparsebase_tpu.ops.reorder as ref_reorder  # noqa: E402
from sparsebase_tpu.bases import ReorderBase as RefReorderBase  # noqa: E402
from sparsebase_tpu.ops.reorder import gray as ref_gray  # noqa: E402

import fixture as fx  # noqa: E402
import sparsebase_tpu_torch as sbt  # noqa: E402
import sparsebase_tpu_torch.ops.reorder as reorder  # noqa: E402
from sparsebase_tpu_torch import COO, CSR, DenseArray, ReorderBase, get_config, set_config  # noqa: E402
from sparsebase_tpu_torch.ops.reorder import gray  # noqa: E402
from sparsebase_tpu_torch.utils.exceptions import ReorderError  # noqa: E402

GOLDEN = Path(__file__).resolve().parent / "golden"


@pytest.fixture
def saved_config():
    """Both packages' settings, restored after the test."""
    saved, ref_saved = get_config(), ref.get_config()
    yield
    set_config(**{f: getattr(saved, f) for f in saved.__dataclass_fields__})
    ref.set_config(**{f: getattr(ref_saved, f) for f in ref_saved.__dataclass_fields__})


def use_graphkit(on: bool) -> None:
    set_config(use_graphkit=on)
    ref.set_config(use_graphkit=on)


# -- graphs, made with numpy from a seed ---------------------------------------
def sorted_pattern(row, col, n):
    """``(indptr int64, indices int32)`` of the row-major-sorted entries,
    duplicates kept."""
    row, col = np.asarray(row, np.int64), np.asarray(col, np.int64)
    order = np.lexsort((col, row))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(row, minlength=n))]).astype(np.int64)
    return indptr, col[order].astype(np.int32)


def random_pairs(seed, n, m, pairs, symmetric=False, dups=0, empty=()):
    """``pairs`` uniform entries (with ``dups`` of them repeated), mirrored
    when ``symmetric``; rows and columns in ``empty`` hold no entry."""
    rng = np.random.default_rng(seed)
    row, col = rng.integers(0, n, pairs), rng.integers(0, m, pairs)
    if dups:
        row, col = np.r_[row, row[:dups]], np.r_[col, col[:dups]]
    if symmetric:
        row, col = np.r_[row, col], np.r_[col, row]
    keep = ~np.isin(row, empty) & ~np.isin(col, empty)
    return row[keep], col[keep]


def banded_pairs(n, half, seed, extra=0):
    """Every entry within ``half`` of the diagonal, plus ``extra`` uniform ones."""
    i = np.repeat(np.arange(n), 2 * half + 1)
    j = i + np.tile(np.arange(-half, half + 1), n)
    keep = (j >= 0) & (j < n)
    rng = np.random.default_rng(seed)
    return np.r_[i[keep], rng.integers(0, n, extra)], np.r_[j[keep], rng.integers(0, n, extra)]


def mixed_degrees(seed, n=120, m=120):
    """Rows of many degrees: empty rows, sparse rows and a few dense rows."""
    rng = np.random.default_rng(seed)
    deg = rng.choice([0, 1, 2, 3, 5, 8, 9, 14, 30], size=n, p=[.1, .15, .15, .15, .1, .1, .1, .1, .05])
    row = np.repeat(np.arange(n), deg)
    return row, rng.integers(0, m, row.size)


def grid_pairs(side):
    v = np.arange(side * side).reshape(side, side)
    r = np.r_[v[:, :-1].ravel(), v[:-1, :].ravel()]
    c = np.r_[v[:, 1:].ravel(), v[1:, :].ravel()]
    return np.r_[r, c], np.r_[c, r]


def star_pairs(n):
    leaves = np.arange(1, n)
    return np.r_[np.zeros(n - 1, np.int64), leaves], np.r_[leaves, np.zeros(n - 1, np.int64)]


def two_cliques():
    rows, cols = [], []
    for a, b in itertools.permutations(range(4), 2):
        rows += [a, a + 4]
        cols += [b, b + 4]
    return np.array(rows + [0, 4]), np.array(cols + [4, 0])


# name -> (row, col, (n, m))
GRAPHS = {
    "fixture": lambda: (fx.ROWS, fx.COO_COLS, (3, 3)),
    "random-80": lambda: (*random_pairs(0, 80, 80, 320), (80, 80)),
    "symmetric-60": lambda: (*random_pairs(1, 60, 60, 150, symmetric=True), (60, 60)),
    "duplicates": lambda: (*random_pairs(2, 50, 50, 150, dups=40), (50, 50)),
    "empty-rows": lambda: (*random_pairs(3, 70, 70, 200, symmetric=True, empty=(0, 5, 6, 33, 69)), (70, 70)),
    "wide": lambda: (*random_pairs(4, 40, 90, 200), (40, 90)),
    "tall": lambda: (*random_pairs(5, 90, 40, 200), (90, 40)),
    "mixed-degrees": lambda: (*mixed_degrees(6), (120, 120)),
    "banded": lambda: (*banded_pairs(100, 2, 7, extra=20), (100, 100)),
    "narrow-10": lambda: (*random_pairs(8, 60, 10, 240), (60, 10)),
    "grid-9": lambda: (*grid_pairs(9), (81, 81)),
    "no-entries": lambda: (np.zeros(0, np.int64), np.zeros(0, np.int64), (12, 12)),
}


def graph(name):
    row, col, shape = GRAPHS[name]()
    indptr, indices = sorted_pattern(row, col, shape[0])
    return indptr, indices, shape


def port_csr(indptr, indices, shape):
    return CSR(torch.from_numpy(indptr), torch.from_numpy(indices), None, shape)


def ref_csr(indptr, indices, shape, device=False):
    if device:
        return ref.CSR(jnp.asarray(indptr), jnp.asarray(indices), None, shape)
    return ref.CSR(indptr, indices, None, shape)


def port_coo(row, col, shape):
    row, col = np.asarray(row, np.int32), np.asarray(col, np.int32)
    return COO.new(torch.from_numpy(row), torch.from_numpy(col), None, shape)


def ref_coo(row, col, shape):
    return ref.COO.new(np.asarray(row, np.int32), np.asarray(col, np.int32), None, shape=shape)


def golden(name):
    indptr = np.loadtxt(GOLDEN / name / "csr_indptr.txt", dtype=np.int64)
    indices = np.loadtxt(GOLDEN / name / "csr_indices.txt", dtype=np.int32)
    n = indptr.size - 1
    return indptr, indices, (n, n)


def load(name, file, dtype=np.int64):
    return np.loadtxt(GOLDEN / name / file, dtype=dtype)


def assert_order(got: torch.Tensor, want, n: int) -> None:
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sorted(got.tolist()) == list(range(n))


# -- Gray ------------------------------------------------------------------------
GRAY_PARAMS = {
    "default": dict(),
    "res16-thr4": dict(resolution=16, nnz_threshold=4),
    "res3-thr1-group2": dict(resolution=3, nnz_threshold=1, sparse_density_group_size=2),
    "res64-group1": dict(resolution=64, nnz_threshold=2, sparse_density_group_size=1),
    "res40-thr0": dict(resolution=40, nnz_threshold=0),
}


@pytest.mark.parametrize("route", ["numpy", "jnp"])
@pytest.mark.parametrize("params", sorted(GRAY_PARAMS))
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_gray_equals_jax(name, params, route):
    indptr, indices, shape = graph(name)
    kw = GRAY_PARAMS[params]
    want = ref_reorder.GrayReorder(**kw).get_reorder(ref_csr(indptr, indices, shape, device=route == "jnp"))
    got = reorder.GrayReorder(**kw).get_reorder(port_csr(indptr, indices, shape))
    assert_order(got, want, shape[0])


def band_share_graph(in_band: int, total: int, n: int = 200):
    """Sparse rows (one entry each) of which ``in_band`` are on the diagonal
    and ``total - in_band`` far from it, plus dense rows far from it."""
    rows = np.arange(total)
    cols = np.where(rows < in_band, rows, (rows + n // 2) % n)
    dense = np.repeat(np.arange(total, total + 4), 20)
    dcols = (dense + 50 + np.tile(np.arange(20), 4)) % n
    return sorted_pattern(np.r_[rows, dense], np.r_[cols, dcols], n) + ((n, n),)


@pytest.mark.parametrize("in_band,total,banded", [(3, 10, False), (31, 100, True), (30, 100, False), (4, 10, True)])
def test_gray_band_share_is_an_exact_comparison(in_band, total, banded):
    """A sparse share of exactly 3/10 is not "more than 30%"; the integer
    test says so as the float64 one does, and the order equals JAX's."""
    indptr, indices, shape = band_share_graph(in_band, total)
    csr = port_csr(indptr, indices, shape)
    row = csr.row_of_nnz().long()
    near = (csr.indices.long() - row).abs() <= max(shape[1] // 128, 1)
    a, b = gray._banded_counts((csr.degrees() <= 8)[row], near)
    assert (int(a), int(b)) == (in_band, total)
    assert bool(10 * a > 3 * b) == banded == (in_band / total > 0.3)
    for device in (False, True):
        want = ref_reorder.GrayReorder().get_reorder(ref_csr(indptr, indices, shape, device))
        assert_order(reorder.GrayReorder().get_reorder(csr), want, shape[0])


def test_gray_dense_rank_equals_jax():
    values = np.random.default_rng(9).integers(0, 40, 500)
    got = gray._dense_rank(torch.from_numpy(values), 6)
    np.testing.assert_array_equal(got.numpy(), ref_gray._dense_rank(np, values))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_gray._dense_rank(jnp, jnp.asarray(values))))


def test_gray_golden_g960():
    """The reference library's order, exactly (ash958 is not compared: the
    reference writes past its bitmap there, ``tests/test_parity.py:117``)."""
    indptr, indices, shape = golden("g960")
    got = reorder.GrayReorder(32, 8, 8).get_reorder(port_csr(indptr, indices, shape))
    assert_order(got, load("g960", "gray_order.txt"), shape[0])


@pytest.mark.parametrize("kw", [dict(resolution=3, nnz_threshold=1, sparse_density_group_size=2),
                                dict(resolution=16, nnz_threshold=4), dict(resolution=16)])
def test_gray_is_a_permutation(kw):
    """``TestGray``'s cases (fixture, random-100, random-50)."""
    for name in ("fixture", "random-80", "symmetric-60"):
        indptr, indices, shape = graph(name)
        order = reorder.GrayReorder(**kw).get_reorder(port_csr(indptr, indices, shape))
        fx.check_reorder(order.numpy(), shape[0])


# -- BOBA ------------------------------------------------------------------------
@pytest.mark.parametrize("sequential", [False, True], ids=["parallel", "sequential"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_boba_equals_jax(name, sequential):
    row, col, shape = GRAPHS[name]()
    want = ref_reorder.BOBAReorder(sequential).get_reorder(ref_coo(row, col, shape))
    got = reorder.BOBAReorder(sequential).get_reorder(port_coo(row, col, shape))
    assert_order(got, want, max(shape))


def test_boba_duplicates_and_isolated_vertices():
    """Duplicate entries all the same (the order of equal pairs cannot move
    the appearance sequence) and isolated vertices, which follow in id order."""
    row = np.array([5, 5, 5, 2, 2, 9, 0, 5, 2])
    col = np.array([1, 1, 1, 7, 7, 3, 1, 1, 7])
    shape = (12, 12)
    got = reorder.BOBAReorder().get_reorder(port_coo(row, col, shape))
    assert_order(got, ref_reorder.BOBAReorder().get_reorder(ref_coo(row, col, shape)), 12)
    isolated = [4, 6, 8, 10, 11]
    assert got[isolated].tolist() == list(range(7, 12))


def test_boba_first_seen_order():
    """``TestBOBA``: entries by (col, row) give rows 1, 2, 0 then cols; the
    order is v1, v2, v0; isolated vertices come last; a CSR converts."""
    assert reorder.BOBAReorder().get_reorder(port_coo(fx.ROWS, fx.COO_COLS, (3, 3))).tolist() == [2, 0, 1]
    order = reorder.BOBAReorder().get_reorder(port_coo([0], [1], (4, 4)))
    fx.check_reorder(order.numpy(), 4)
    assert order[2] > order[0] and order[3] > order[0]
    indptr, indices, shape = graph("symmetric-60")
    fx.check_reorder(reorder.BOBAReorder().get_reorder(port_csr(indptr, indices, shape)).numpy(), 60)


@pytest.mark.parametrize("name", ["ash958_sym", "g960"])
def test_boba_golden(name):
    indptr, indices, shape = golden(name)
    got = reorder.BOBAReorder().get_reorder(port_csr(indptr, indices, shape))
    assert_order(got, load(name, "boba_order.txt"), shape[0])


# -- heatmap ---------------------------------------------------------------------
def heatmap_orders(name, shape):
    rng = np.random.default_rng(sum(map(ord, name)))
    return {
        "natural": (np.arange(shape[0]), np.arange(shape[1])),
        "random": (rng.permutation(shape[0]), rng.permutation(shape[1])),
    }


@pytest.mark.parametrize("route", ["numpy", "jnp"])
@pytest.mark.parametrize("parts", [1, 3, 8])
@pytest.mark.parametrize("name", sorted(set(GRAPHS) - {"fixture", "narrow-10"}))
def test_heatmap_equals_jax(name, parts, route):
    indptr, indices, shape = graph(name)
    for label, (order_r, order_c) in heatmap_orders(name, shape).items():
        r32, c32 = order_r.astype(np.int32), order_c.astype(np.int32)
        if route == "jnp":
            want_heat, want = ref_reorder.ReorderHeatmap(parts).get_heatmap_with_stats(
                ref_csr(indptr, indices, shape, True), ref.DenseArray(jnp.asarray(r32)),
                ref.DenseArray(jnp.asarray(c32)))
        else:
            want_heat, want = RefReorderBase.heatmap_with_stats(ref_csr(indptr, indices, shape), r32, c32, parts)
        heat, got = ReorderBase.heatmap_with_stats(port_csr(indptr, indices, shape), torch.from_numpy(r32),
                                                   torch.from_numpy(c32), parts)
        assert heat.vals.dtype == torch.float32
        np.testing.assert_array_equal(heat.vals.numpy(), np.asarray(want_heat.vals), err_msg=label)
        grid_only = ReorderBase.heatmap(port_csr(indptr, indices, shape), r32, c32, parts)
        assert torch.equal(grid_only.vals, heat.vals)
        assert sorted(got) == sorted(want)
        for key in ("max_bw", "num_full_blocks"):
            assert got[key] == want[key] and isinstance(got[key], int), (label, key)
        assert got["block_mean_bw"] == want["block_mean_bw"], label
        np.testing.assert_allclose(got["mean_bw"], want["mean_bw"], rtol=1e-6, err_msg=label)


def test_heatmap_mean_bw_is_the_exact_sum():
    indptr, indices, shape = graph("random-80")
    csr = port_csr(indptr, indices, shape)
    _, stats = ReorderBase.heatmap_with_stats(csr, np.arange(80), np.arange(80), 4)
    bw = np.abs(np.repeat(np.arange(80), np.diff(indptr)) - indices)
    assert stats["mean_bw"] == int(bw.sum()) / bw.size and stats["max_bw"] == int(bw.max())


@pytest.mark.parametrize("name", ["ash958_sym", "g960"])
def test_heatmap_golden(name):
    """The reference library's grids on the natural and degree orders at 3
    and 8 parts, held as ``tests/test_parity.py:347-365`` holds JAX's."""
    indptr, indices, shape = golden(name)
    csr = port_csr(indptr, indices, shape)
    for parts in (3, 8):
        for tag, order in (("natural", np.arange(shape[0])), ("degree", load(name, "degree_order.txt"))):
            order = torch.from_numpy(order.astype(np.int32))
            got = reorder.ReorderHeatmap(parts).get_heatmap(csr, DenseArray(order), DenseArray(order)).vals
            want = load(name, f"heatmap_{tag}_{parts}.txt", np.float64)
            np.testing.assert_allclose(got.numpy().astype(np.float64), want, atol=1.5e-6)


def test_heatmap_fixture():
    """``TestHeatmap``: natural and reordered grids, the fused stats."""
    csr = port_csr(fx.ROW_PTR.astype(np.int64), fx.COLS, (3, 3))
    ident = np.arange(3, dtype=np.int32)
    heat = ReorderBase.heatmap(csr, ident, ident, num_parts=3)
    np.testing.assert_allclose(heat.vals.numpy().reshape(3, 3), fx.HEATMAP_NO_ORDER)
    heat = ReorderBase.heatmap(csr, fx.R_REORDER, fx.C_REORDER, num_parts=3)
    np.testing.assert_allclose(heat.vals.numpy().reshape(3, 3), fx.HEATMAP_RC_ORDER)
    heat, stats = ReorderBase.heatmap_with_stats(csr, ident, ident, num_parts=3)
    np.testing.assert_allclose(heat.vals.numpy().reshape(3, 3), fx.HEATMAP_NO_ORDER)
    assert stats == {"mean_bw": 1.5, "max_bw": 2, "num_full_blocks": 4, "block_mean_bw": 1.5}


@pytest.mark.parametrize("shape,parts", [((3, 3), 5), ((10, 4), 5), ((4, 10), 5)])
def test_heatmap_too_many_parts_raises(shape, parts):
    n, m = shape
    csr = port_csr(*sorted_pattern([0, n - 1], [m - 1, 0], n), shape)
    with pytest.raises(ReorderError):
        ReorderBase.heatmap(csr, np.arange(n), np.arange(m), num_parts=parts)


def test_heatmap_of_no_entries():
    csr = port_csr(np.zeros(9, np.int64), np.zeros(0, np.int32), (8, 8))
    heat, stats = ReorderBase.heatmap_with_stats(csr, np.arange(8), np.arange(8), 4)
    assert not heat.vals.any() and stats == {"mean_bw": 0.0, "max_bw": 0, "num_full_blocks": 0, "block_mean_bw": 0.0}


# -- the host reorderers: SlashBurn, AMD, nested dissection, Rabbit ----------------
HOST_REORDERERS = {
    "slashburn-k4-greedy": ("SlashburnReorder", dict(k_size=4)),
    "slashburn-k4": ("SlashburnReorder", dict(k_size=4, greedy=False)),
    "slashburn-k4-hub": ("SlashburnReorder", dict(k_size=4, greedy=False, hub_order=True)),
    "slashburn-k4-greedy-hub": ("SlashburnReorder", dict(k_size=4, hub_order=True)),
    "slashburn-k1": ("SlashburnReorder", dict(k_size=1)),
    "amd": ("AMDReorder", dict()),
    "amd-not-aggressive": ("AMDReorder", dict(aggressive=False)),
    "amd-dense-0": ("AMDReorder", dict(dense=0)),
    "amd-dense-1": ("AMDReorder", dict(dense=1.0)),
    "metis": ("MetisReorder", dict()),
    "metis-seed0-leaf8": ("MetisReorder", dict(seed=0, leaf_size=8)),
    "rabbit": ("RabbitReorder", dict()),
}
HOST_GRAPHS = ["fixture", "symmetric-60", "empty-rows", "random-80", "duplicates", "grid-9", "banded", "no-entries"]


@pytest.mark.parametrize("graphkit", [True, False], ids=["graphkit", "numpy"])
@pytest.mark.parametrize("name", HOST_GRAPHS)
@pytest.mark.parametrize("which", sorted(HOST_REORDERERS))
def test_host_reorderer_equals_jax(saved_config, which, name, graphkit):
    use_graphkit(graphkit)
    cls, kw = HOST_REORDERERS[which]
    indptr, indices, shape = graph(name)
    if cls == "MetisReorder" and name == "no-entries" and not graphkit:
        # the JAX numpy route raises on a graph with no entries
        # (``multilevel._symmetrize``); the port's gives a permutation
        with pytest.raises(IndexError):
            getattr(ref_reorder, cls)(**kw).get_reorder(ref_csr(indptr, indices, shape))
        fx.check_reorder(getattr(reorder, cls)(**kw).get_reorder(port_csr(indptr, indices, shape)).numpy(), 12)
        return
    want = getattr(ref_reorder, cls)(**kw).get_reorder(ref_csr(indptr, indices, shape))
    got = getattr(reorder, cls)(**kw).get_reorder(port_csr(indptr, indices, shape))
    assert_order(got, want, shape[0])


@pytest.mark.parametrize("graphkit", [True, False], ids=["graphkit", "numpy"])
@pytest.mark.parametrize("which", ["amd", "metis-seed0-leaf8", "rabbit", "slashburn-k4-greedy"])
def test_host_reorderer_on_larger_grid_equals_jax(saved_config, which, graphkit):
    """A 16 × 16 grid: several levels of dissection and of SlashBurn."""
    use_graphkit(graphkit)
    cls, kw = HOST_REORDERERS[which]
    row, col = grid_pairs(16)
    indptr, indices = sorted_pattern(row, col, 256)
    want = getattr(ref_reorder, cls)(**kw).get_reorder(ref_csr(indptr, indices, (256, 256)))
    assert_order(getattr(reorder, cls)(**kw).get_reorder(port_csr(indptr, indices, (256, 256))), want, 256)


@pytest.mark.parametrize("graphkit", [True, False], ids=["graphkit", "numpy"])
def test_slashburn_hub_first(saved_config, graphkit):
    """``TestSlashburn``: the star's centre is the first hub."""
    use_graphkit(graphkit)
    indptr, indices = sorted_pattern(*star_pairs(20), 20)
    assert int(reorder.SlashburnReorder(k_size=2).get_reorder(port_csr(indptr, indices, (20, 20)))[0]) == 0


@pytest.mark.parametrize("graphkit", [True, False], ids=["graphkit", "numpy"])
@pytest.mark.parametrize("name", ["ash958_sym", "g960"])
def test_slashburn_golden(saved_config, name, graphkit):
    """The reference's SlashBurn as ``tests/test_parity.py:391-437`` holds the
    JAX package to it: greedy, the hub set of every round (ash958 to round
    12); not greedy, the round-0 hub degrees (with and without hub order)."""
    use_graphkit(graphkit)
    indptr, indices, shape = golden(name)
    csr = port_csr(indptr, indices, shape)
    k = 8
    ref_order = load(name, "slashburn_k8_greedy.txt")
    ours = reorder.SlashburnReorder(k_size=k, greedy=True).get_reorder(csr).numpy().astype(np.int64)
    for r in range(12 if name == "ash958_sym" else 24):
        lo, hi = r * k, (r + 1) * k
        assert set(np.nonzero((ref_order >= lo) & (ref_order < hi))[0]) == set(np.nonzero((ours >= lo) & (ours < hi))[0])
    deg = np.diff(indptr)
    for file, kw in (("slashburn_k8.txt", dict(greedy=False)), ("slashburn_k8_hub.txt", dict(greedy=False,
                                                                                              hub_order=True))):
        ref_order = load(name, file)
        ours = reorder.SlashburnReorder(k_size=k, **kw).get_reorder(csr).numpy()
        assert sorted(deg[ref_order < k]) == sorted(deg[ours < k])


@pytest.mark.parametrize("graphkit", [True, False], ids=["graphkit", "numpy"])
def test_amd_star_centre_last(saved_config, graphkit):
    """``TestAMD``: the hub of a star is eliminated last."""
    use_graphkit(graphkit)
    indptr, indices = sorted_pattern(*star_pairs(10), 10)
    for kw in (dict(), dict(dense=0)):
        assert int(reorder.AMDReorder(**kw).get_reorder(port_csr(indptr, indices, (10, 10)))[0]) == 9


@pytest.mark.parametrize("graphkit", [True, False], ids=["graphkit", "numpy"])
def test_rabbit_two_cliques_contiguous(saved_config, graphkit):
    """``TestRabbit``: each of two joined K4s takes consecutive positions."""
    use_graphkit(graphkit)
    indptr, indices = sorted_pattern(*two_cliques(), 8)
    order = reorder.RabbitReorder().get_reorder(port_csr(indptr, indices, (8, 8))).numpy()
    fx.check_reorder(order, 8)
    for half in (order[:4], order[4:]):
        assert half.max() - half.min() == 3


@pytest.mark.parametrize("graphkit", [True, False], ids=["graphkit", "numpy"])
@pytest.mark.parametrize("side", [8, 10, 12])
def test_fill_reducing_orders_on_grids(saved_config, side, graphkit):
    """``TestAMD`` and ``TestMetisReorder`` on grids: valid orders, equal to
    JAX's."""
    use_graphkit(graphkit)
    n = side * side
    indptr, indices = sorted_pattern(*grid_pairs(side), n)
    for cls, kw in (("AMDReorder", dict()), ("MetisReorder", dict(seed=0))):
        want = getattr(ref_reorder, cls)(**kw).get_reorder(ref_csr(indptr, indices, (n, n)))
        assert_order(getattr(reorder, cls)(**kw).get_reorder(port_csr(indptr, indices, (n, n))), want, n)


def test_metis_params_keep_every_field():
    params = reorder.MetisReorder(ctype="rm", nseps=2, compress=0, pfactor=3, rtype="x").params
    assert list(params.__dataclass_fields__) == list(ref_reorder.MetisReorder().params.__dataclass_fields__)


# -- generic, the façade, the exports ---------------------------------------------
def test_generic_reorder_user_registered():
    op = reorder.GenericReorder()
    op.register((CSR,), lambda f, p: torch.arange(f[0].nrows, dtype=torch.int32).flip(0))
    assert op.get_reorder(port_csr(fx.ROW_PTR.astype(np.int64), fx.COLS, (3, 3))).tolist() == [2, 1, 0]
    assert op.params is None


def test_exports_match_jax():
    assert set(ref_reorder.__all__) <= set(reorder.__all__)
    for name in ref_reorder.__all__:
        assert hasattr(reorder, name)


ALIASES = ["degree", "rcm", "gray", "slashburn", "boba", "amd", "metis", "nested_dissection", "rabbit"]


@pytest.mark.parametrize("alias", ALIASES + ["GRAY", "Nested_Dissection"])
def test_facade_resolves_every_name(alias):
    want = RefReorderBase._resolve(alias).__name__
    assert ReorderBase._resolve(alias) is getattr(reorder, want)


@pytest.mark.parametrize("alias", ALIASES)
def test_facade_reorders_by_name_as_jax(saved_config, alias):
    indptr, indices, shape = graph("symmetric-60")
    want = RefReorderBase.reorder(alias, ref_csr(indptr, indices, shape))
    assert_order(ReorderBase.reorder(alias, port_csr(indptr, indices, shape)), want, 60)


def test_facade_unknown_name_raises_key_error():
    with pytest.raises(KeyError):
        ReorderBase.reorder("hilbert", port_csr(fx.ROW_PTR.astype(np.int64), fx.COLS, (3, 3)))


def test_facade_params_and_cached():
    """``TestReorderBaseFacade``: params as a dict; the cached form returns
    the conversions run (COO -> CSR for Gray, CSR -> COO for BOBA)."""
    csr = port_csr(fx.ROW_PTR.astype(np.int64), fx.COLS, (3, 3))
    order = ReorderBase.reorder("gray", csr, params={"resolution": 3, "nnz_threshold": 1})
    fx.check_reorder(order.numpy(), 3)
    converted, order = ReorderBase.reorder_cached("boba", csr)
    assert isinstance(converted[0], COO) and order.tolist() == [2, 0, 1]
    converted, order = ReorderBase.reorder_cached(reorder.GrayReorder, port_coo(fx.ROWS, fx.COO_COLS, (3, 3)))
    assert isinstance(converted[0], CSR)
    fx.check_reorder(order.numpy(), 3)


def test_package_root_exports_the_facade():
    assert sbt.ReorderBase is ReorderBase and hasattr(ReorderBase, "heatmap_with_stats")
