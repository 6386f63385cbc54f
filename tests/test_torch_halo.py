"""Port parity for the halo-exchange functions (``parallel/halo.py``), on the CPU.

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py`` gives
(``make_mesh(4|8)``); the port on meshes that name the CPU 4 or 8 times.
Graphs are numpy arrays from a seed. Every result must equal the JAX
function's exactly (BFS levels, component labels, RCM orders, partition
labels, cuts, the counting rank, ``step_comm_bytes``), except the SpMV:
rtol 1e-5, atol 1e-5 (K2's per-row sums against XLA's ``segment_sum``).
Weighted cases use integer weights, whose float32 sums are exact; other
weights are held to the cap and to the input's cut. Each JAX function
compiles once per shape, so the cases share a few graphs.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import sparsebase_tpu as ref  # noqa: E402
from sparsebase_tpu.convert import coo_to_csr as ref_coo_to_csr  # noqa: E402
from sparsebase_tpu.parallel import ShardedCSR as RefShardedCSR  # noqa: E402
from sparsebase_tpu.parallel import dist as ref_dist  # noqa: E402
from sparsebase_tpu.parallel import halo as ref_halo  # noqa: E402
from sparsebase_tpu.parallel import make_mesh as ref_make_mesh  # noqa: E402

import fixture as fx  # noqa: E402
from sparsebase_tpu_torch.interop import from_reference  # noqa: E402
from sparsebase_tpu_torch.parallel import ShardedCSR, collectives, dist, halo, make_mesh  # noqa: E402

CPU = torch.device("cpu")
SHARDS = (4, 8)


@pytest.fixture(scope="module", params=SHARDS, ids=lambda d: f"d{d}")
def meshes(request):
    """``(JAX mesh, port mesh)`` of d shards."""
    d = request.param
    assert len(jax.devices()) >= d, "conftest must provide 8 virtual devices"
    return ref_make_mesh(d), make_mesh(devices=["cpu"] * d)


def csr_of(row, col, shape, vals=None):
    row, col = np.asarray(row, np.int64), np.asarray(col, np.int64)
    keys, first = np.unique(row * shape[1] + col, return_index=True)
    if vals is not None:
        vals = np.asarray(vals, np.float32)[first]
    return ref_coo_to_csr(ref.COO.new((keys // shape[1]).astype(np.int32), (keys % shape[1]).astype(np.int32), vals,
                                      shape=shape))


def random_csr(seed, n=64, avg_deg=5, with_vals=True, symmetric=False):
    """A reference CSR of seeded random entries, without duplicates."""
    rng = np.random.default_rng(seed)
    row, col = rng.integers(0, n, n * avg_deg), rng.integers(0, n, n * avg_deg)
    if symmetric:
        keep = row != col
        row, col = np.concatenate([row[keep], col[keep]]), np.concatenate([col[keep], row[keep]])
    vals = rng.standard_normal(len(row)) if with_vals else None
    return csr_of(row, col, (n, n), vals)


def path_csr(n):
    return csr_of(np.r_[np.arange(n - 1), np.arange(1, n)], np.r_[np.arange(1, n), np.arange(n - 1)], (n, n))


def rect_csr():
    """The 10×15 CSR of ROADMAP.md §3 (fault 3.4): columns past the rows."""
    return csr_of([0, 1, 2, 5, 9], [1, 12, 0, 14, 3], (10, 15))


def both(rc, meshes):
    """``(ref sharded, port sharded)`` of a reference CSR, with halo lists."""
    rmesh, pmesh = meshes
    return RefShardedCSR.from_csr(rc, rmesh, halo=True), ShardedCSR.from_csr(from_reference(rc, CPU), pmesh, halo=True)


def assert_same(got, want):
    want = np.asarray(want)
    assert isinstance(got, torch.Tensor) and got.device == CPU
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got.numpy(), want)


GRAPHS = {
    "random": lambda: random_csr(0),
    "sparse-pattern": lambda: random_csr(1, n=48, avg_deg=2, with_vals=False),
    "symmetric": lambda: random_csr(2, n=80, avg_deg=2, with_vals=False, symmetric=True),
    "rectangular": rect_csr,
}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graph(request, meshes):
    """``(meshes, ref csr, ref sharded, port sharded)`` per graph and mesh."""
    rc = GRAPHS[request.param]()
    return (meshes, rc) + both(rc, meshes)


# -- the exchange, its bytes and the collectives ---------------------------------
class TestExchange:
    def test_exchange_fills_the_halo_slots(self, graph):
        (rmesh, pmesh), rc, rs, ps = graph
        n, d, rows = rc.nrows, ps.n_shards, ps.rows_per_shard
        x = torch.arange(n, dtype=torch.float32) + 1
        ext = halo._exchange(halo._put(ps, x), halo._sends(ps), ps.axis)
        s = ps.halo_width
        send = ps.stacked("halo_send").numpy()
        padded = np.r_[x.numpy(), np.zeros(d * rows - n, np.float32)].reshape(d, rows)
        for r in range(d):
            assert ext[r].shape == (rows + d * s,)
            np.testing.assert_array_equal(ext[r][:rows].numpy(), padded[r])
            for o in range(d):
                # slot (owner o, j) holds owner o's row halo_send[o][r, j], clamped to its rows
                got = ext[r][rows + o * s : rows + (o + 1) * s].numpy()
                np.testing.assert_array_equal(got, padded[o][np.minimum(send[o, r], rows - 1)])

    def test_step_comm_bytes(self, graph):
        (rmesh, pmesh), rc, rs, ps = graph
        for itemsize in (4, 8):
            assert halo.step_comm_bytes(ps, itemsize) == ref_halo.step_comm_bytes(rs, itemsize)
        assert halo.step_comm_bytes(ps) == ps.halo_bytes_per_exchange

    def test_all_gather(self):
        parts = [torch.arange(3) + 10 * k for k in range(4)]
        out = collectives.all_gather(parts)
        assert len(out) == 4
        for o in out:
            np.testing.assert_array_equal(o.numpy(), np.stack([p.numpy() for p in parts]))
        assert all(o is out[0] for o in out)  # one device: the stack is shared


class TestCommVolume:
    def test_boundary_proportional(self, meshes):
        n = 512
        rs, ps = both(path_csr(n), meshes)
        per_step = halo.step_comm_bytes(ps)
        assert per_step == ref_halo.step_comm_bytes(rs)
        d = ps.n_shards
        assert per_step == 2 * (d - 1) * 4  # one vertex each way across each internal cut
        assert per_step < n * 4

    def test_halo_counts_match_boundary(self, meshes):
        rs, ps = both(path_csr(512), meshes)
        counts = ps.stacked("halo_counts").numpy()
        d = ps.n_shards
        want = np.array([[1 if abs(o - r) == 1 else 0 for r in range(d)] for o in range(d)])
        np.testing.assert_array_equal(counts, want)
        np.testing.assert_array_equal(counts, np.asarray(rs.halo_counts))

    def test_spmv_makes_one_all_to_all_and_no_psum(self, meshes, monkeypatch):
        """The counterpart of the JAX HLO check: one ``all_to_all`` a SpMV,
        no dense (n,) ``psum``."""
        _, ps = both(path_csr(64), meshes)
        calls = []

        def counting(name, fn):
            def wrapped(parts, *a, **k):
                calls.append((name, tuple(parts[0].shape)))
                return fn(parts, *a, **k)
            return wrapped

        for name in ("all_to_all", "psum", "pmax", "pmin", "all_gather"):
            monkeypatch.setattr(halo, name, counting(name, getattr(collectives, name)))
            monkeypatch.setattr(collectives, name, counting(name, getattr(collectives, name)))
        y = halo.spmv(ps, torch.ones(64), meshes[1])
        assert [c[0] for c in calls] == ["all_to_all"]
        assert calls[0][1] == (ps.n_shards, ps.halo_width)
        assert y.shape == (64,)


# -- the functions against JAX, graph by graph -----------------------------------
class TestAgainstJax:
    def test_spmv(self, graph):
        (rmesh, pmesh), rc, rs, ps = graph
        x = np.random.default_rng(1).standard_normal(rc.nrows).astype(np.float32)
        got = halo.spmv(ps, torch.as_tensor(x), pmesh)
        want = np.asarray(ref_halo.spmv(rs, jnp.asarray(x), rmesh))
        assert got.shape == want.shape and got.device == CPU
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        if rc.nrows == rc.ncols:
            np.testing.assert_allclose(got.numpy(), dist.spmv(ps, torch.as_tensor(x), pmesh).numpy(), rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(got.numpy(), np.asarray(rc.to_dense()) @ x, rtol=1e-4, atol=1e-4)

    def test_bfs_levels(self, graph):
        (rmesh, pmesh), rc, rs, ps = graph
        stats = {}
        got = halo.bfs_levels(ps, 0, pmesh, stats=stats)
        assert got.dtype == torch.int32
        assert_same(got, ref_halo.bfs_levels(rs, 0, rmesh))
        assert_same(got, ref_dist.bfs_levels(rs, 0, rmesh))
        assert stats["host_reads"] == stats["levels"] + 1
        assert_same(halo.bfs_levels(ps, 0, pmesh, max_iters=1), ref_halo.bfs_levels(rs, 0, rmesh, max_iters=1))

    def test_label_prop_partition(self, graph):
        (rmesh, pmesh), rc, rs, ps = graph
        got = halo.label_prop_partition(ps, 4, pmesh, num_iters=8)
        assert got.dtype == torch.int32
        assert_same(got, ref_halo.label_prop_partition(rs, 4, rmesh, num_iters=8))
        fx.check_partition(got.numpy(), rc.nrows, 4)

    def test_label_prop_partition_integer_weights(self, graph):
        (rmesh, pmesh), rc, rs, ps = graph
        w = np.random.default_rng(3).integers(1, 6, rc.nrows).astype(np.float32)
        got = halo.label_prop_partition(ps, 3, pmesh, num_iters=6, vertex_weights=torch.as_tensor(w))
        assert_same(got, ref_halo.label_prop_partition(rs, 3, rmesh, num_iters=6, vertex_weights=jnp.asarray(w)))

    def test_connected_components(self, graph):
        (rmesh, pmesh), rc, rs, ps = graph
        stats = {}
        got = halo.connected_components(ps, pmesh, stats=stats)
        assert got.dtype == torch.int32
        assert_same(got, ref_halo.connected_components(rs, rmesh))
        assert stats["host_reads"] == stats["rounds"] + stats["jumps"] and stats["jumps"] >= stats["rounds"] >= 1

    def test_rcm_reorder(self, graph):
        (rmesh, pmesh), rc, rs, ps = graph
        got = halo.rcm_reorder(ps, pmesh, root=0)
        assert got.dtype == torch.int32
        assert_same(got, ref_halo.rcm_reorder(rs, rmesh, root=0))
        fx.check_reorder(got.numpy(), rc.nrows)

    def test_edge_cut(self, graph):
        (rmesh, pmesh), rc, rs, ps = graph
        labels = np.random.default_rng(2).integers(0, 3, rc.nrows).astype(np.int32)
        got = halo.edge_cut(ps, torch.as_tensor(labels), pmesh)
        assert int(got) == int(ref_halo.edge_cut(rs, jnp.asarray(labels), rmesh))
        if rc.nrows == rc.ncols:  # past the rows the two JAX gathers clamp to different rows
            assert int(got) == int(ref_dist.edge_cut(rs, jnp.asarray(labels), rmesh))
            assert int(got) == int(dist.edge_cut(ps, torch.as_tensor(labels), pmesh))

    def test_refine_partition(self, graph):
        (rmesh, pmesh), rc, rs, ps = graph
        labels = np.random.default_rng(4).integers(0, 3, rc.nrows).astype(np.int32)
        got = halo.refine_partition(ps, torch.as_tensor(labels), 3, pmesh, rounds=3)
        assert got.dtype == torch.int32
        assert_same(got, ref_halo.refine_partition(rs, jnp.asarray(labels), 3, rmesh, rounds=3))

    def test_refine_partition_integer_weights(self, graph):
        (rmesh, pmesh), rc, rs, ps = graph
        labels = np.random.default_rng(5).integers(0, 3, rc.nrows).astype(np.int32)
        w = np.random.default_rng(6).integers(1, 5, rc.nrows).astype(np.float32)
        got = halo.refine_partition(ps, torch.as_tensor(labels), 3, pmesh, vertex_weights=torch.as_tensor(w),
                                    gain_buckets=4)
        want = ref_halo.refine_partition(rs, jnp.asarray(labels), 3, rmesh, vertex_weights=jnp.asarray(w),
                                         gain_buckets=4)
        assert_same(got, want)


class TestRequiresHalo:
    CALLS = {
        "spmv": lambda sh, m: halo.spmv(sh, torch.ones(sh.shape[0]), m),
        "bfs_levels": lambda sh, m: halo.bfs_levels(sh, 0, m),
        "label_prop_partition": lambda sh, m: halo.label_prop_partition(sh, 2, m),
        "connected_components": lambda sh, m: halo.connected_components(sh, m),
        "rcm_reorder": lambda sh, m: halo.rcm_reorder(sh, m),
        "edge_cut": lambda sh, m: halo.edge_cut(sh, torch.zeros(sh.shape[0], dtype=torch.int32), m),
        "refine_partition": lambda sh, m: halo.refine_partition(sh, torch.zeros(sh.shape[0], dtype=torch.int32), 2, m),
        "step_comm_bytes": lambda sh, m: halo.step_comm_bytes(sh),
    }

    @pytest.mark.parametrize("name", sorted(CALLS))
    def test_raises_without_halo_lists(self, name):
        mesh = make_mesh(devices=["cpu"] * 4)
        sh = ShardedCSR.from_csr(from_reference(random_csr(0), CPU), mesh, halo=False)
        with pytest.raises(ValueError, match="halo"):
            self.CALLS[name](sh, mesh)

    def test_spmv_needs_x_of_n_entries(self):
        mesh = make_mesh(devices=["cpu"] * 4)
        sh = ShardedCSR.from_csr(from_reference(rect_csr(), CPU), mesh)
        with pytest.raises(ValueError, match="10 rows"):
            halo.spmv(sh, torch.ones(15), mesh)


# -- the JAX suite's cases (tests/test_halo.py, tests/test_slashburn_dist.py) -----
class TestHaloSpmv:
    def test_pattern_matrix(self, meshes):
        rs, ps = both(path_csr(24), meshes)
        got = halo.spmv(ps, torch.ones(24), meshes[1])
        want = np.full(24, 2.0, np.float32)
        want[0] = want[-1] = 1.0
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_halo.spmv(rs, jnp.ones(24), meshes[0])), rtol=1e-5,
                                   atol=1e-5)

    def test_ingest_then_halo_spmv(self, meshes):
        rc = random_csr(7, n=72, avg_deg=4)
        pc = from_reference(rc, CPU)
        sh = ShardedCSR.from_coo_sharded(pc.row_of_nnz(), pc.indices, pc.vals, pc.shape, meshes[1]).with_halo()
        x = np.random.default_rng(8).standard_normal(72).astype(np.float32)
        got = halo.spmv(sh, torch.as_tensor(x), meshes[1])
        np.testing.assert_allclose(got.numpy(), np.asarray(rc.to_dense()) @ x, rtol=1e-4, atol=1e-4)


class TestHaloBfs:
    def test_path_levels(self, meshes):
        rs, ps = both(path_csr(16), meshes)
        got = halo.bfs_levels(ps, 0, meshes[1])
        assert got.tolist() == list(range(16))
        assert_same(got, ref_halo.bfs_levels(rs, 0, meshes[0]))

    def test_disconnected(self, meshes):
        rs, ps = both(csr_of([0, 1], [1, 0], (8, 8)), meshes)
        got = halo.bfs_levels(ps, 0, meshes[1])
        assert got[:2].tolist() == [0, 1] and bool((got[2:] == -1).all())
        assert_same(got, ref_halo.bfs_levels(rs, 0, meshes[0]))


class TestHaloLabelProp:
    def test_locality_on_blocks(self, meshes):
        # two cliques joined by one edge: a 2-way partition cuts about 1 edge
        n, half = 32, 16
        blocks = [(b + i, b + j) for b in (0, half) for i in range(half) for j in range(half) if i != j]
        edges = blocks + [(half - 1, half), (half, half - 1)]
        rs, ps = both(csr_of([u for u, _ in edges], [v for _, v in edges], (n, n)), meshes)
        got = halo.label_prop_partition(ps, 2, meshes[1], num_iters=10)
        assert_same(got, ref_halo.label_prop_partition(rs, 2, meshes[0], num_iters=10))
        assert int(halo.edge_cut(ps, got, meshes[1])) <= 4


class TestHaloRcm:
    def test_path_bandwidth_one(self, meshes):
        n = 32
        rc = path_csr(n)
        rs, ps = both(rc, meshes)
        got = halo.rcm_reorder(ps, meshes[1], root=0)
        assert_same(got, ref_halo.rcm_reorder(rs, meshes[0], root=0))
        row, col = np.r_[np.arange(n - 1), np.arange(1, n)], np.r_[np.arange(1, n), np.arange(n - 1)]
        assert np.abs(got.numpy()[row] - got.numpy()[col]).max() == 1

    def test_reduces_bandwidth(self, meshes):
        n = 96
        perm = np.random.default_rng(7).permutation(n)
        pairs = [(perm[i], perm[j]) for i in range(n) for j in range(max(0, i - 2), min(n, i + 3)) if i != j]
        r, c = np.array([p for p, _ in pairs]), np.array([q for _, q in pairs])
        rs, ps = both(csr_of(r, c, (n, n)), meshes)
        got = halo.rcm_reorder(ps, meshes[1])
        assert_same(got, ref_halo.rcm_reorder(rs, meshes[0]))
        order = got.numpy()
        assert np.abs(order[r] - order[c]).max() <= 8 < np.abs(r - c).max()

    @pytest.mark.parametrize("budget", [dict(max_buckets=1 << 10), dict(max_buckets=64, deg_buckets=8),
                                        dict(refine_iters=0), dict(peripheral_iters=0, max_rank_levels=3)])
    def test_bucket_budget_and_options(self, budget):
        rmesh, pmesh = ref_make_mesh(4), make_mesh(devices=["cpu"] * 4)
        rs, ps = both(random_csr(9, n=60, avg_deg=2, with_vals=False, symmetric=True), (rmesh, pmesh))
        assert_same(halo.rcm_reorder(ps, pmesh, **budget), ref_halo.rcm_reorder(rs, rmesh, **budget))

    @pytest.mark.parametrize("nb,seed", [(7, 0), (64, 1), (1000, 2)])
    def test_counting_rank(self, meshes, nb, seed):
        """The distributed counting rank against the JAX runner: random keys,
        rows past n invalid."""
        rmesh, pmesh = meshes
        rs, ps = both(random_csr(0), meshes)
        d, rows, n = ps.n_shards, ps.rows_per_shard, ps.shape[0]
        keys = np.random.default_rng(seed).integers(0, nb, (d, rows)).astype(np.int32)
        valid = (np.arange(d * rows) < n).reshape(d, rows)
        valid[0, :3] = False  # invalid rows inside a shard too
        want = ref_halo._counting_rank_runner(rmesh, "x", n, d, rows, nb)(jnp.asarray(keys), jnp.asarray(valid))
        got, ghist = halo._counting_rank(ps, [torch.as_tensor(k) for k in keys], [torch.as_tensor(v) for v in valid], nb)
        np.testing.assert_array_equal(torch.stack(got).numpy(), np.asarray(want))
        np.testing.assert_array_equal(ghist.numpy(), np.bincount(keys[valid], minlength=nb))


class TestHaloRefine:
    def test_refine_reduces_cut(self, meshes):
        n, k = 96, 4
        rs, ps = both(random_csr(11, n=n, avg_deg=6), meshes)
        rng = np.random.default_rng(0)
        labels0 = (np.arange(n) * k // n).astype(np.int32)
        labels0[rng.integers(0, n, 32)] = rng.integers(0, k, 32)
        got = halo.refine_partition(ps, torch.as_tensor(labels0), k, meshes[1], rounds=4)
        assert_same(got, ref_halo.refine_partition(rs, jnp.asarray(labels0), k, meshes[0], rounds=4))
        cut0, cut1 = (int(halo.edge_cut(ps, torch.as_tensor(lab), meshes[1])) for lab in (labels0, got))
        assert cut1 <= cut0
        assert np.bincount(got.numpy(), minlength=k).max() <= 1.3 * n / k

    def test_refine_respects_headroom(self, meshes):
        n, k = 64, 2
        rs, ps = both(random_csr(12, n=n, avg_deg=4), meshes)
        labels0 = (np.arange(n) >= n // 4).astype(np.int32)  # part 1 holds 75%
        got = halo.refine_partition(ps, torch.as_tensor(labels0), k, meshes[1], rounds=3)
        assert_same(got, ref_halo.refine_partition(rs, jnp.asarray(labels0), k, meshes[0], rounds=3))
        assert np.bincount(got.numpy(), minlength=k)[1] <= np.bincount(labels0, minlength=k)[1]

    def test_fractional_weights_respect_the_cap(self, meshes):
        """Weights that are not integers: the float32 sums may round
        otherwise than XLA's, so the labels are held to the cap (within
        float32 rounding, 1e-5 of the total) and to the input's cut."""
        n, k, balance = 96, 4, 1.1
        rs, ps = both(random_csr(13, n=n, avg_deg=6), meshes)
        w = np.random.default_rng(1).uniform(0.5, 2.0, n).astype(np.float32)
        labels0 = (np.arange(n) * k // n).astype(np.int32)
        got = halo.refine_partition(ps, torch.as_tensor(labels0), k, meshes[1], vertex_weights=torch.as_tensor(w),
                                    balance=balance).numpy()
        sizes = np.bincount(got, weights=w, minlength=k)
        assert sizes.max() <= balance * w.sum() / k + 1e-5 * w.sum()
        cut = lambda lab: int(halo.edge_cut(ps, torch.as_tensor(lab), meshes[1]))  # noqa: E731
        assert cut(got) <= cut(labels0)


def random_sym_csr(rng, n=80, avg_deg=3):
    row, col = rng.integers(0, n, n * avg_deg), rng.integers(0, n, n * avg_deg)
    keep = row != col
    return csr_of(np.r_[row[keep], col[keep]], np.r_[col[keep], row[keep]], (n, n))


class TestConnectedComponents:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_scipy(self, meshes, seed):
        n = 72 + 8 * seed
        rc = random_sym_csr(np.random.default_rng(seed), n=n, avg_deg=2)
        rs, ps = both(rc, meshes)
        got = halo.connected_components(ps, meshes[1])
        assert_same(got, ref_halo.connected_components(rs, meshes[0]))
        m = sp.csr_matrix((np.ones(rc.nnz), np.asarray(rc.indices), np.asarray(rc.indptr)), shape=(n, n))
        count, want = csgraph.connected_components(m, directed=False)
        got = got.numpy()
        for lab in np.unique(got):
            members = got == lab
            assert len(np.unique(want[members])) == 1 and lab == np.nonzero(members)[0].min()
        assert len(np.unique(got)) == count

    def test_alive_mask(self, meshes):
        n = 16
        rs, ps = both(path_csr(n), meshes)
        alive = np.ones(n, bool)
        alive[8] = False
        got = halo.connected_components(ps, meshes[1], alive=torch.as_tensor(alive))
        assert_same(got, ref_halo.connected_components(rs, meshes[0], alive=alive))
        assert got[8] == -1 and bool((got[:8] == 0).all()) and bool((got[9:] == 9).all())

    def test_tiny_graph(self, meshes):
        # n < shards: shards with no row below n are harmless
        edges = [(0, 1), (1, 2), (0, 2), (3, 4)]
        r, c = [u for u, v in edges] + [v for u, v in edges], [v for u, v in edges] + [u for u, v in edges]
        rs, ps = both(csr_of(r, c, (5, 5)), meshes)
        got = halo.connected_components(ps, meshes[1])
        assert got.tolist() == [0, 0, 0, 3, 3]
        assert_same(got, ref_halo.connected_components(rs, meshes[0]))

    def test_max_iters(self, meshes):
        rs, ps = both(path_csr(40), meshes)
        got = halo.connected_components(ps, meshes[1], max_iters=1)
        assert_same(got, ref_halo.connected_components(rs, meshes[0], max_iters=1))


class TestRectangular:
    """ROADMAP.md §3's 10×15 input (columns past the rows): every halo
    function returns JAX's result."""

    def test_every_function(self, meshes):
        rmesh, pmesh = meshes
        rs, ps = both(rect_csr(), meshes)
        x = np.arange(10, dtype=np.float32)
        np.testing.assert_allclose(halo.spmv(ps, torch.as_tensor(x), pmesh).numpy(),
                                   np.asarray(ref_halo.spmv(rs, jnp.asarray(x), rmesh)), rtol=1e-5, atol=1e-5)
        lab = np.array([0, 1] * 5, np.int32)
        pairs = [
            (halo.bfs_levels(ps, 0, pmesh), ref_halo.bfs_levels(rs, 0, rmesh)),
            (halo.label_prop_partition(ps, 2, pmesh), ref_halo.label_prop_partition(rs, 2, rmesh)),
            (halo.connected_components(ps, pmesh), ref_halo.connected_components(rs, rmesh)),
            (halo.rcm_reorder(ps, pmesh), ref_halo.rcm_reorder(rs, rmesh)),
            (halo.refine_partition(ps, torch.as_tensor(lab), 2, pmesh), ref_halo.refine_partition(rs, jnp.asarray(lab), 2,
                                                                                                rmesh)),
        ]
        for got, want in pairs:
            assert_same(got, want)
        assert int(halo.edge_cut(ps, torch.as_tensor(lab), pmesh)) == int(ref_halo.edge_cut(rs, jnp.asarray(lab), rmesh))
        assert halo.bfs_levels(ps, 0, pmesh).tolist() == [0, 1] + [-1] * 8
