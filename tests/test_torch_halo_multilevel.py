"""Port parity for the multilevel half of ``parallel/halo.py`` (matching,
contraction, the multilevel BFS and RCM, the V-cycle partitioner, SlashBurn),
on the CPU.

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py`` gives
(``make_mesh(4|8)``); the port on meshes that name the CPU 4 or 8 times.
Graphs are numpy arrays from a seed, with integer edge weights, whose
float32 sums are exact: every result must equal the JAX function's exactly
(matchings, coarse containers and maps, levels and step counts, orders,
labels); the coarse values are compared in canonical order within a (row,
column) run, whose order the JAX sorts leave undefined. Each JAX contraction
compiles its route anew (about 7 s on this CPU), so the ladders are one level
deep and the cases share a few graphs. ``rcm_reorder_ml`` is held to JAX's
rank of JAX's multilevel levels (``dist._rcm_rank_runner``, the JAX
function's own body); SlashBurn's grid of cases is held to the JAX host
order (``_slashburn_host``), which the JAX distributed function equals on
them (``tests/test_slashburn_dist.py``), and to the JAX distributed function
itself on one graph a mesh.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from sparsebase_tpu.formats.csr import CSR as RefCSR  # noqa: E402
from sparsebase_tpu.ops.reorder.slashburn import SlashburnReorderParams as RefSlashburnParams  # noqa: E402
from sparsebase_tpu.ops.reorder.slashburn import _slashburn_host as ref_slashburn_host  # noqa: E402
from sparsebase_tpu.parallel import dist as ref_dist  # noqa: E402
from sparsebase_tpu.parallel import halo as ref_halo  # noqa: E402
from sparsebase_tpu.parallel import make_mesh as ref_make_mesh  # noqa: E402

import fixture as fx  # noqa: E402
from sparsebase_tpu_torch.interop import from_reference  # noqa: E402
from sparsebase_tpu_torch.ops.kernels import radix  # noqa: E402
from sparsebase_tpu_torch.parallel import ShardedCSR, dist, halo, make_mesh  # noqa: E402
from test_torch_halo import both, csr_of, path_csr, rect_csr  # noqa: E402

CPU = torch.device("cpu")
SHARDS = (4, 8)


@pytest.fixture(scope="module", params=SHARDS, ids=lambda d: f"d{d}")
def meshes(request):
    """``(JAX mesh, port mesh)`` of d shards."""
    d = request.param
    assert len(jax.devices()) >= d, "conftest must provide 8 virtual devices"
    return ref_make_mesh(d), make_mesh(devices=["cpu"] * d)


def weighted_graph(seed=0, n=64, pairs=200):
    """A symmetric graph with integer weights, the same both ways."""
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, pairs), rng.integers(0, n, pairs)
    keep = r != c
    r, c = r[keep], c[keep]
    keys, first = np.unique(np.minimum(r, c) * n + np.maximum(r, c), return_index=True)
    lo, hi = keys // n, keys % n
    w = rng.integers(1, 5, len(keys))
    return csr_of(np.r_[lo, hi], np.r_[hi, lo], (n, n), np.r_[w, w])


def assert_same(got, want):
    want = np.asarray(want)
    assert isinstance(got, torch.Tensor) and got.device == CPU
    assert got.shape == want.shape and got.dtype == torch.int32, (got.shape, got.dtype, want.shape)
    np.testing.assert_array_equal(got.numpy(), want)


def entries(rc):
    """``(row, col, val)`` of a reference CSR as numpy arrays."""
    indptr = np.asarray(rc.indptr)
    vals = np.ones(rc.nnz, np.float32) if rc.vals is None else np.asarray(rc.vals)
    return np.repeat(np.arange(rc.nrows), np.diff(indptr)), np.asarray(rc.indices).astype(np.int64), vals


@pytest.fixture(scope="module")
def weighted(meshes):
    """The weighted graph on both meshes: ``(meshes, ref csr, ref sharded,
    port sharded)``."""
    rc = weighted_graph()
    return (meshes, rc) + both(rc, meshes)


# -- heavy-edge matching --------------------------------------------------------
class TestMatching:
    @pytest.mark.parametrize("rounds", [1, 4])
    @pytest.mark.parametrize("weighted_edges", [True, False], ids=["weighted", "pattern"])
    def test_equals_jax(self, weighted, weighted_edges, rounds):
        (rmesh, pmesh), rc, rs, ps = weighted
        got = halo.heavy_edge_matching(ps, pmesh, rounds=rounds, weighted=weighted_edges)
        assert_same(got, ref_halo.heavy_edge_matching(rs, rmesh, rounds=rounds, weighted=weighted_edges))
        m = got.numpy()
        assert np.array_equal(m[m], np.arange(rc.nrows))  # an involution
        row, col, _ = entries(rc)
        edges = set(zip(row.tolist(), col.tolist()))
        assert all((v, int(m[v])) in edges for v in np.nonzero(m != np.arange(rc.nrows))[0])
        if rounds > 1:
            assert (m != np.arange(rc.nrows)).sum() >= rc.nrows // 2

    def test_luby_priority_wraps_as_int32(self):
        """The tie-break hash against numpy's int32 arithmetic, whose
        products wrap, at ids up to 2**31 - 1 and rounds past the wrap."""
        ids = np.r_[np.arange(50), np.random.default_rng(0).integers(0, 2**31 - 1, 200), 2**31 - 1].astype(np.int32)
        for it in (0, 1, 7, 1000, 2**20):
            with np.errstate(over="ignore"):
                salt = np.int32(it) * np.int32(-1640531527)
                want = ((ids ^ salt) * np.int32(-1028477379)) & np.int32(0x7FFFFFFF)
            got = halo._luby_priority(torch.as_tensor(ids, dtype=torch.int64), it)
            np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


# -- contraction ----------------------------------------------------------------
def canonical(sh_fields, k):
    """Shard ``k``'s true entries ``(local row, col, val)`` in canonical order."""
    indptr, indices, vals, cnt = (sh_fields[name][k] for name in ("indptr", "indices", "vals", "nnz_local"))
    cnt = int(cnt)
    lrow = np.repeat(np.arange(indptr.shape[0] - 1), np.diff(indptr))
    order = np.lexsort((vals[:cnt], indices[:cnt], lrow))
    return lrow[order], indices[:cnt][order], vals[:cnt][order]


class TestCoarsen:
    def test_equals_jax(self, weighted):
        (rmesh, pmesh), rc, rs, ps = weighted
        match = np.array(ref_halo.heavy_edge_matching(rs, rmesh, rounds=4))
        want, want_map = ref_halo.coarsen(rs, jnp.asarray(match), rmesh, return_mapping=True)
        stats = {}
        got, got_map = halo.coarsen(ps, torch.as_tensor(match), pmesh, return_mapping=True, stats=stats)
        assert_same(got_map, want_map)
        assert got.shape == tuple(want.shape) and got.width == np.asarray(want.indices).shape[1]
        assert stats == {"host_reads": 4}  # nc, the route's capacity and loads, the halo width
        w = {name: np.asarray(getattr(want, name)) for name in ("indptr", "indices", "vals", "nnz_local",
                                                                 "halo_send", "halo_counts", "halo_map")}
        g = {name: got.stacked(name).numpy() for name in w}
        for name in ("indptr", "nnz_local", "halo_send", "halo_counts"):
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)
        for k in range(got.n_shards):
            for a, b in zip(canonical(g, k), canonical(w, k)):
                np.testing.assert_array_equal(a, b)
            cnt = int(g["nnz_local"][k])
            np.testing.assert_array_equal(g["halo_map"][k, :cnt], w["halo_map"][k, :cnt])
            np.testing.assert_array_equal(g["indices"][k, cnt:], w["indices"][k, cnt:])
        # the plain contraction of the same map: a multiset of (cu, cv, w)
        row, col, val = entries(rc)
        cid = got_map.numpy().astype(np.int64)
        keep = cid[row] != cid[col]
        plain = sorted(zip(cid[row][keep].tolist(), cid[col][keep].tolist(), val[keep].tolist()))
        back = got.to_csr()
        brow = np.repeat(np.arange(back.nrows), np.diff(back.indptr.numpy()))
        assert sorted(zip(brow.tolist(), back.indices.tolist(), back.vals.tolist())) == plain

    def test_without_halo_and_a_pattern_matrix(self, meshes):
        rc = path_csr(40)
        rs, ps = both(rc, meshes)
        match = halo.heavy_edge_matching(ps, meshes[1], rounds=8, weighted=False)
        coarse, cid = halo.coarsen(ps, match, meshes[1], halo=False, return_mapping=True)
        assert not coarse.has_halo and coarse.vals is not None
        assert coarse.shape[0] == int(cid.max()) + 1 < 40
        assert torch.equal(coarse.with_halo().to_csr().indptr, halo.coarsen(ps, match, meshes[1]).to_csr().indptr)


# -- the level correction, the multilevel BFS and RCM ----------------------------
class TestLevelCorrection:
    @pytest.mark.parametrize("rounds", [1, 3])
    def test_equals_jax(self, weighted, rounds):
        (rmesh, pmesh), rc, rs, ps = weighted
        n, d, rows = rc.nrows, ps.n_shards, ps.rows_per_shard
        lev = np.random.default_rng(rounds).integers(-1, 12, n).astype(np.int32)
        run = ref_halo._level_correct_runner(rmesh, "x", n, d, rows, np.asarray(rs.indices).shape[1],
                                             rs.halo_send.shape[2], rounds)
        padded = np.r_[lev, np.full(d * rows - n, -1, np.int32)].reshape(d, rows)
        want = np.asarray(run(rs.indptr, rs.nnz_local, rs.halo_send, rs.halo_map, jnp.asarray(padded))).reshape(-1)[:n]
        assert_same(halo._level_correct(ps, torch.as_tensor(lev), pmesh, rounds), want)


@pytest.fixture
def bits_stated(monkeypatch):
    """``dist.radix_rank`` sorting by the stated key bits alone, as K5 does
    (the CPU's plain sort reads every bit)."""
    monkeypatch.setattr(dist, "radix_rank", lambda keys, key_bits=None: radix.radix_passes_plain(
        keys, key_bits, inverse=True)[0])


class TestMultilevelBfsAndRcm:
    def test_path_whose_levels_exceed_n(self, meshes, bits_stated):
        """A 15-vertex path, one contraction: approximate levels up to 16,
        past n and past the 4 bits that ``bits_below(n + 1)`` would state."""
        rmesh, pmesh = meshes
        rc = path_csr(15)
        rs, ps = both(rc, meshes)
        want, want_steps = ref_halo.bfs_levels_multilevel(rs, 0, rmesh, coarsen_until=9)
        stats = {}
        got, steps = halo.bfs_levels_multilevel(ps, 0, pmesh, coarsen_until=9, stats=stats)
        assert_same(got, want)
        assert steps == want_steps == 2 * 8 + 3 + stats["coarse_depth"] + 2
        assert stats["levels"] == 1 and stats["sizes"] == [15, 9] and int(got.max()) == 16
        # the contraction's 4 reads, then one a BFS level: 9 levels on the 9
        # coarse vertices, where the loop ends without a last read
        assert stats["coarse_depth"] == 9 and stats["host_reads"] == 4 + 9
        deg = ref_dist.degrees(rs, rmesh)
        rank = ref_dist._rcm_rank_runner(15)(want, deg)  # JAX's rcm_reorder_ml on its levels
        order, ml_steps = halo.rcm_reorder_ml(ps, pmesh, coarsen_until=9)
        assert_same(order, rank)
        assert ml_steps == want_steps
        fx.check_reorder(order.numpy(), 15)

    def test_rcm_rank_states_the_largest_level(self, bits_stated):
        """``dist._rcm_rank`` on levels past n against JAX's lexsort rank."""
        rng = np.random.default_rng(5)
        for n, top in ((15, 40), (64, 64), (100, 300), (9, 8)):
            levels = rng.integers(-1, top + 1, n).astype(np.int32)
            deg = rng.integers(0, 7, n).astype(np.int32)
            want = ref_dist._rcm_rank_runner(n)(jnp.asarray(levels), jnp.asarray(deg))
            assert_same(dist._rcm_rank(torch.as_tensor(levels), torch.as_tensor(deg, dtype=torch.int64), n), want)

    def test_projection_saturates(self):
        """Past 2**30 a doubled level would wrap in int32 (JAX's cast makes it
        negative, read as unreached); the port saturates at INT32_MAX - 1."""
        coarse = torch.tensor([-1, 0, 7, 2**30 - 1, 2**30, 2**31 - 2], dtype=torch.int32)
        got = halo._project_levels(coarse)
        assert got.dtype == torch.int32
        assert got.tolist() == [-1, 0, 14, 2**31 - 2, 2**31 - 2, 2**31 - 2]

    def test_exact_where_nothing_contracts(self, weighted):
        """At most ``coarsen_until`` vertices: the exact BFS, its levels as
        the step count."""
        (rmesh, pmesh), rc, rs, ps = weighted
        got, steps = halo.bfs_levels_multilevel(ps, 3, pmesh, coarsen_until=rc.nrows)
        want, want_steps = ref_halo.bfs_levels_multilevel(rs, 3, rmesh, coarsen_until=rc.nrows)
        assert_same(got, want)
        assert steps == want_steps
        assert_same(got, halo.bfs_levels(ps, 3, pmesh))


# -- the V-cycle partitioner ------------------------------------------------------
class TestMultilevelPartition:
    def test_equals_jax(self, weighted):
        (rmesh, pmesh), rc, rs, ps = weighted
        stats = {}
        got = halo.multilevel_partition(ps, 3, pmesh, coarsen_until=48, stats=stats)
        assert_same(got, ref_halo.multilevel_partition(rs, 3, rmesh, coarsen_until=48))
        assert stats["levels"] == 1 and stats["sizes"][0] == rc.nrows > stats["sizes"][1]
        fx.check_partition(got.numpy(), rc.nrows, 3)
        assert np.bincount(got.numpy(), minlength=3).max() <= 1.1 * rc.nrows / 3

    @pytest.mark.parametrize("branch", ["host", "label-prop"])
    def test_coarsest_init_equals_jax(self, meshes, branch):
        """Past 4096 vertices the coarsest graph is partitioned by label
        propagation on the mesh, else on the host (region growing and
        refinement from ``default_rng(0x5EED)``)."""
        rmesh, pmesh = meshes
        rc = weighted_graph(1) if branch == "host" else path_csr(4100)
        rs, ps = both(rc, meshes)
        vw = np.random.default_rng(2).integers(1, 4, rc.nrows).astype(np.float32)
        want = ref_halo._coarsest_init(rs, 4, rmesh, jnp.asarray(vw), 1.1, 5)
        assert_same(halo._coarsest_init(ps, 4, pmesh, torch.as_tensor(vw), 1.1, 5), want)

    @pytest.mark.parametrize("case", ["overloaded", "feasible", "infeasible"])
    def test_enforce_balance_equals_jax(self, meshes, case, capsys):
        """``tests/test_partition.py``'s cases: 80% of the vertices in part 0
        (restored to the cap), labels within the cap (returned as they are),
        and a cap no labelling meets (the best effort, with a warning)."""
        rmesh, pmesh = meshes
        rng = np.random.default_rng(0)
        n = 96
        row, col = rng.integers(0, n, n * 5), rng.integers(0, n, n * 5)
        row, col = np.r_[row, col], np.r_[col, row]
        keep = row != col
        rs, ps = both(csr_of(row[keep], col[keep], (n, n)), meshes)
        k, balance = (5, 1.0) if case == "infeasible" else (4, 1.1)
        labels = {"overloaded": np.where(np.arange(n) < 77, 0, np.arange(n) % k),
                  "feasible": np.arange(n) % k, "infeasible": np.where(np.arange(n) < 50, 0, np.arange(n) % k)}[case]
        labels = labels.astype(np.int32)
        want = ref_halo._enforce_balance(rs, jnp.asarray(labels), k, rmesh, balance)
        capsys.readouterr()
        got = halo._enforce_balance(ps, torch.as_tensor(labels), k, pmesh, balance)
        assert_same(got, want)
        sizes = np.bincount(got.numpy(), minlength=k)
        if case == "infeasible":
            assert sizes.max() > balance * n / k and "infeasible" in capsys.readouterr().out
        else:
            assert sizes.max() <= balance * n / k
        if case == "feasible":
            np.testing.assert_array_equal(got.numpy(), labels)


# -- SlashBurn ------------------------------------------------------------------
def random_sym_csr(rng, n=80, avg_deg=3):
    """``tests/test_slashburn_dist.py``'s graph: a symmetric pattern, no
    self-loops."""
    row, col = rng.integers(0, n, n * avg_deg).astype(np.int64), rng.integers(0, n, n * avg_deg).astype(np.int64)
    keep = row != col
    row, col = np.r_[row[keep], col[keep]], np.r_[col[keep], row[keep]]
    return csr_of(row, col, (n, n))


def star_hub_csr(hub_order_graph: bool):
    """``tests/test_slashburn_dist.py``'s star graphs: one hub of 70 spokes
    over a random background (its hub removal collapses the live entries, so
    compaction runs), or two hubs of degrees 40 and 25, past a
    ``bucket_cap`` of 8."""
    if hub_order_graph:
        rng, n = np.random.default_rng(11), 96
        r = np.r_[np.zeros(70, np.int64), rng.integers(1, n, 60)]
        c = np.r_[np.arange(1, 71), rng.integers(1, n, 60)]
    else:
        rng, n = np.random.default_rng(9), 64
        hubs = [(0, v) for v in range(20, 60)] + [(1, v) for v in range(30, 55)]
        r = np.r_[[u for u, _ in hubs], rng.integers(2, n, 40)]
        c = np.r_[[v for _, v in hubs], rng.integers(2, n, 40)]
    keep = r != c
    return csr_of(np.r_[r[keep], c[keep]], np.r_[c[keep], r[keep]], (n, n))


def host_order(rc, k, hub_order=False):
    """The JAX host SlashBurn (``greedy=False``), the exact oracle."""
    csr = RefCSR(np.asarray(rc.indptr), np.asarray(rc.indices), None, rc.shape)
    return np.asarray(ref_slashburn_host(csr, RefSlashburnParams(k_size=k, greedy=False, hub_order=hub_order)))


TIERS = {
    "hybrid": {},
    "distributed": {"host_tail": 0, "host_tail_nnz": 0},
    "no-compaction": {"host_tail": 0, "host_tail_nnz": 0, "compact_ratio": 0.0},
    "count-tail": {"host_tail": 16, "host_tail_nnz": 0},
    "nnz-tail": {"host_tail": 0, "host_tail_nnz": 40},
}


class TestSlashburn:
    def test_equals_jax_with_compaction(self, meshes):
        rmesh, pmesh = meshes
        rs, ps = both(star_hub_csr(True), meshes)
        for hub_order in (False, True):
            stats = {}
            got = halo.slashburn_reorder(ps, pmesh, k_size=8, hub_order=hub_order, stats=stats, **TIERS["distributed"])
            assert_same(got, ref_halo.slashburn_reorder(rs, rmesh, k_size=8, hub_order=hub_order,
                                                        **TIERS["distributed"]))
            assert stats["compactions"] >= 1 and stats["phases"] == stats["compactions"] + 1 and stats["rounds"] >= 2

    @pytest.mark.parametrize("seed,k,hub_order", [(0, 8, False), (1, 4, False), (2, 8, True), (3, 16, False)])
    def test_matches_host_exactly(self, meshes, seed, k, hub_order):
        rc = random_sym_csr(np.random.default_rng(seed), n=64 + 8 * seed)
        _, ps = both(rc, meshes)
        got = halo.slashburn_reorder(ps, meshes[1], k_size=k, hub_order=hub_order, **TIERS["distributed"])
        assert_same(got, host_order(rc, k, hub_order))

    @pytest.mark.parametrize("tier", sorted(TIERS))
    @pytest.mark.parametrize("hub_order", [False, True])
    def test_all_tiers_agree(self, meshes, tier, hub_order):
        rc = star_hub_csr(True)
        _, ps = both(rc, meshes)
        stats = {}
        got = halo.slashburn_reorder(ps, meshes[1], k_size=8, hub_order=hub_order, stats=stats, **TIERS[tier])
        assert_same(got, host_order(rc, 8, hub_order))
        assert (stats["host_tail"] > 0) == (tier != "distributed" and tier != "no-compaction")

    def test_star_hubs_past_bucket_cap(self, meshes):
        rc = star_hub_csr(False)
        _, ps = both(rc, meshes)
        assert_same(halo.slashburn_reorder(ps, meshes[1], k_size=4, bucket_cap=8), host_order(rc, 4))
        assert_same(halo.slashburn_reorder(ps, meshes[1], k_size=4, bucket_cap=8, **TIERS["distributed"]),
                    host_order(rc, 4))

    def test_tiny_graph(self, meshes):
        rc = random_sym_csr(np.random.default_rng(42), n=12, avg_deg=2)
        _, ps = both(rc, meshes)
        assert_same(halo.slashburn_reorder(ps, meshes[1], k_size=4), host_order(rc, 4))
        assert_same(halo.slashburn_reorder(ps, meshes[1], k_size=4, **TIERS["distributed"]), host_order(rc, 4))

    def test_active_degree_and_nbr_min_equal_jax(self, weighted):
        (rmesh, pmesh), rc, rs, ps = weighted
        n, d, rows = rc.nrows, ps.n_shards, ps.rows_per_shard
        args = (rmesh, "x", n, d, rows, np.asarray(rs.indices).shape[1], rs.halo_send.shape[2])
        rng = np.random.default_rng(3)
        alive = np.r_[rng.random(n) < 0.7, np.zeros(d * rows - n, bool)].reshape(d, rows)
        vals = np.r_[rng.integers(0, 50, n), np.full(d * rows - n, 2**31 - 1)].astype(np.int32).reshape(d, rows)
        want_deg = ref_halo._active_degree_runner(*args)(rs.indptr, rs.nnz_local, rs.halo_send, rs.halo_map,
                                                          jnp.asarray(alive))
        want_min = ref_halo._nbr_min_runner(*args)(rs.indptr, rs.nnz_local, rs.halo_send, rs.halo_map,
                                                   jnp.asarray(vals))
        got_deg = halo._active_degree(ps, [torch.as_tensor(a) for a in alive])
        got_min = halo._nbr_min(ps, [torch.as_tensor(v) for v in vals])
        np.testing.assert_array_equal(torch.stack(got_deg).numpy(), np.asarray(want_deg))
        np.testing.assert_array_equal(torch.stack(got_min).numpy(), np.asarray(want_min))


# -- the 10×15 input of fault 3.4 -------------------------------------------------
class TestRectangular:
    """ROADMAP.md §3's 10×15 input (columns past the rows): every new
    function whose JAX counterpart returns on it returns JAX's result (JAX's
    ``multilevel_partition`` raises there, in its host symmetrization)."""

    def test_every_function(self, meshes):
        rmesh, pmesh = meshes
        rs, ps = both(rect_csr(), meshes)
        assert_same(halo.heavy_edge_matching(ps, pmesh), ref_halo.heavy_edge_matching(rs, rmesh))
        ident = np.arange(10, dtype=np.int32)
        coarse, cid = halo.coarsen(ps, torch.as_tensor(ident), pmesh, return_mapping=True)
        want, want_cid = ref_halo.coarsen(rs, jnp.asarray(ident), rmesh, return_mapping=True)
        assert_same(cid, want_cid)
        assert coarse.shape == tuple(want.shape) and coarse.nnz_counts == tuple(np.asarray(want.nnz_local).tolist())
        got, steps = halo.bfs_levels_multilevel(ps, 0, pmesh, coarsen_until=10)
        want, want_steps = ref_halo.bfs_levels_multilevel(rs, 0, rmesh, coarsen_until=10)
        assert_same(got, want)
        assert steps == want_steps
        # below 10 vertices the matching finds no pair: the ladder stalls at
        # once and the exact BFS runs on the input
        stalled, stalled_steps = halo.bfs_levels_multilevel(ps, 0, pmesh, coarsen_until=4)
        assert torch.equal(stalled, got) and stalled_steps == steps + 2 * 8 + 3
        order, _ = halo.rcm_reorder_ml(ps, pmesh, coarsen_until=10)
        assert_same(order, ref_halo.rcm_reorder_ml(rs, rmesh, coarsen_until=10)[0])
        kw = dict(k_size=2, **TIERS["distributed"])
        assert_same(halo.slashburn_reorder(ps, pmesh, **kw), ref_halo.slashburn_reorder(rs, rmesh, **kw))


class TestRequiresHalo:
    CALLS = {
        "heavy_edge_matching": lambda sh, m: halo.heavy_edge_matching(sh, m),
        "coarsen": lambda sh, m: halo.coarsen(sh, torch.arange(sh.shape[0]), m),
        "bfs_levels_multilevel": lambda sh, m: halo.bfs_levels_multilevel(sh, 0, m),
        "rcm_reorder_ml": lambda sh, m: halo.rcm_reorder_ml(sh, m),
        "multilevel_partition": lambda sh, m: halo.multilevel_partition(sh, 2, m),
        "slashburn_reorder": lambda sh, m: halo.slashburn_reorder(sh, m),
    }

    @pytest.mark.parametrize("name", sorted(CALLS))
    def test_raises_without_halo_lists(self, name):
        mesh = make_mesh(devices=["cpu"] * 4)
        sh = ShardedCSR.from_csr(from_reference(path_csr(20), CPU), mesh, halo=False)
        with pytest.raises(ValueError, match="halo"):
            self.CALLS[name](sh, mesh)
