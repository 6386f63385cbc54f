"""Port parity for the ring functions (``parallel/ring.py``) and
``collectives.ppermute``, on the CPU.

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py`` gives
(``make_mesh(4|8)``); the port on meshes that name the CPU 4 or 8 times.
Graphs are numpy arrays from a seed (those of ``tests/test_ring.py``, and a
multiset graph, the 10×15 matrix of fault 3.4 and K4). Counts must equal
the JAX function's exactly; weights bit for bit (both divide the same
integers below 2^24 in float32), padded layout included. Each JAX function
compiles once per graph shape, so the graphs are module-scoped.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from sparsebase_tpu.formats.csr import CSR as RefCSR  # noqa: E402
from sparsebase_tpu.ops.feature.jaccard import _jaccard_host as ref_jaccard_host  # noqa: E402
from sparsebase_tpu.ops.feature.triangles import _directed_count as ref_directed_count  # noqa: E402
from sparsebase_tpu.ops.feature.triangles import _undirected_count as ref_undirected_count  # noqa: E402
from sparsebase_tpu.parallel import ShardedCSR as RefShardedCSR  # noqa: E402
from sparsebase_tpu.parallel import make_mesh as ref_make_mesh  # noqa: E402
from sparsebase_tpu.parallel import ring as ref_ring  # noqa: E402

from sparsebase_tpu_torch.interop import from_reference  # noqa: E402
from sparsebase_tpu_torch.parallel import ShardedCSR, collectives, make_mesh, ring  # noqa: E402
from test_torch_halo import csr_of, rect_csr  # noqa: E402

CPU = torch.device("cpu")
SHARDS = (4, 8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch's CPU ops on one thread: beside the suite's other workers more
    threads oversubscribe the cores, and the sparse ring's many passes over
    large tensors then slow down several-fold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=SHARDS, ids=lambda d: f"d{d}")
def meshes(request):
    """``(JAX mesh, port mesh)`` of d shards."""
    d = request.param
    assert len(jax.devices()) >= d, "conftest must provide 8 virtual devices"
    return ref_make_mesh(d), make_mesh(devices=["cpu"] * d)


def csr_of_pairs(row, col, n):
    """A reference CSR of the pairs as they are (repeats kept), rows sorted
    and each row's columns sorted."""
    row, col = np.asarray(row, np.int64), np.asarray(col, np.int64)
    order = np.lexsort((col, row))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(row, minlength=n))]).astype(np.int32)
    return RefCSR(indptr, col[order].astype(np.int32), None, (n, n))


def random_csr(seed, n, avg_deg=5, symmetric=False):
    """``tests/test_ring.py``'s graphs: uniform pairs without self-loops,
    mirrored where ``symmetric``, repeats dropped."""
    rng = np.random.default_rng(seed)
    row, col = rng.integers(0, n, n * avg_deg), rng.integers(0, n, n * avg_deg)
    keep = row != col
    row, col = row[keep], col[keep]
    if symmetric:
        row, col = np.concatenate([row, col]), np.concatenate([col, row])
    return csr_of(row, col, (n, n))


def complete(n):
    r, c = np.nonzero(1 - np.eye(n, dtype=np.int64))
    return csr_of_pairs(r, c, n)


def cycle_with_chord():
    """The 5-cycle with one chord: exactly 1 triangle."""
    edges = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 0), (0, 2)]
    u, v = np.array(edges).T
    return csr_of(np.r_[u, v], np.r_[v, u], (5, 5))


def loops_and_repeats():
    """Triangle 0-1-2, a self-loop at 0 and the edge 0-1 twice, mirrored."""
    u, v = np.array([(0, 1), (1, 2), (2, 0), (0, 0), (0, 1)]).T
    return csr_of_pairs(np.r_[u, v], np.r_[v, u], 6)


def multiset():
    """A symmetric random graph whose entries are stored again at random
    (a third of them, up to three times), with self-loops: the sparse
    ring's Σ // 6 counts the repeated entries, the dense tile collapses
    them."""
    rng = np.random.default_rng(21)
    n = 40
    u, v = rng.integers(0, n, 160), rng.integers(0, n, 160)
    u, v = np.r_[u, v], np.r_[v, u]
    again = rng.random(len(u)) < 1 / 3
    times = rng.integers(1, 4, len(u))
    return csr_of_pairs(np.r_[u, np.repeat(u[again], times[again]), np.arange(0, n, 7)],
                        np.r_[v, np.repeat(v[again], times[again]), np.arange(0, n, 7)], n)


GRAPHS = {
    "sym0": lambda: random_csr(0, 60, symmetric=True),
    "sym1": lambda: random_csr(1, 67, symmetric=True),
    "sym2": lambda: random_csr(2, 74, avg_deg=6, symmetric=True),
    "dir0": lambda: random_csr(100, 50),
    "dir1": lambda: random_csr(101, 53),
    "k512": lambda: complete(512),
    "k4": lambda: complete(4),
    "cycle": cycle_with_chord,
    "loops": loops_and_repeats,
    "multiset": multiset,
    "rect": rect_csr,
}
SIMPLE = ("sym0", "sym1", "sym2", "k512", "k4", "cycle")  # symmetric, no loops, no repeats
UNDIRECTED = SIMPLE + ("loops", "multiset", "rect")
DIRECTED = ("dir0", "dir1", "k4", "multiset", "rect")
JACCARD = ("sym0", "sym2", "dir0", "dir1", "loops", "multiset", "rect")


@pytest.fixture(scope="module")
def cache():
    return {}


def sharded(cache, meshes, name):
    """``(ref csr, ref sharded, port sharded)`` of a graph on both meshes,
    built once per module."""
    key = (name, meshes[1].size)
    if key not in cache:
        rc = GRAPHS[name]()
        rmesh, pmesh = meshes
        cache[key] = (rc, RefShardedCSR.from_csr(rc, rmesh, halo=False),
                      ShardedCSR.from_csr(from_reference(rc, CPU), pmesh, halo=False))
    return cache[key]


def assert_padded_equal(got, want, sh):
    """Per shard, the port's ``(width,)`` float32 weights equal to the JAX
    row bit for bit, pad slots 0."""
    want = np.asarray(want)
    assert isinstance(got, tuple) and len(got) == want.shape[0]
    for k, t in enumerate(got):
        assert t.dtype == torch.float32 and t.device == CPU and t.shape == (sh.width,)
        np.testing.assert_array_equal(t.numpy(), want[k])
        assert (t[sh.nnz_counts[k]:] == 0).all()


# -- ppermute ---------------------------------------------------------------------
class TestPpermute:
    def test_rotation_moves_each_shard(self):
        parts = [torch.full((3,), float(k)) for k in range(4)]
        got = collectives.ppermute(parts, [(j, (j - 1) % 4) for j in range(4)])
        assert [int(t[0]) for t in got] == [1, 2, 3, 0]
        assert all(a is parts[(k + 1) % 4] for k, a in enumerate(got))  # shared device: the tensor itself

    def test_partial_permutation_fills_zeros(self):
        parts = [torch.arange(2 * k, 2 * k + 2, dtype=torch.int32) for k in range(4)]
        got = collectives.ppermute(parts, [(0, 2), (3, 1)])
        assert [t.tolist() for t in got] == [[0, 0], [6, 7], [0, 1], [0, 0]]
        assert got[0].dtype == torch.int32

    def test_separate_devices_copy(self):
        """A shard on another device receives a copy there (``meta`` stands
        for a second device on the CPU)."""
        parts = [torch.ones(2), torch.empty(2, device="meta")]
        got = collectives.ppermute(parts, [(0, 1)])
        assert got[1].device.type == "meta" and got[1].shape == (2,) and got[1] is not parts[0]
        assert got[0].device == CPU and torch.equal(got[0], torch.zeros(2))

    def test_equals_jax_ppermute(self):
        from jax.sharding import PartitionSpec as P

        mesh = ref_make_mesh(4)
        x = np.arange(12, dtype=np.float32).reshape(4, 3)
        perm = [(0, 3), (3, 1), (2, 2)]
        want = jax.shard_map(lambda b: jax.lax.ppermute(b, "x", perm), mesh=mesh, in_specs=P("x"),
                             out_specs=P("x"))(x)
        got = collectives.ppermute([torch.from_numpy(r.copy()) for r in x], perm)
        np.testing.assert_array_equal(torch.stack(got).numpy(), np.asarray(want))

    @pytest.mark.parametrize("perm", [[(0, 1), (0, 2)], [(0, 1), (2, 1)], [(0, 4)]])
    def test_rejects_what_is_no_permutation(self, perm):
        with pytest.raises(ValueError, match="permutation"):
            collectives.ppermute([torch.zeros(1)] * 4, perm)


# -- the dense and sparse rings -----------------------------------------------------
TRIANGLES = {"k512": 512 * 511 * 510 // 6, "k4": 4, "cycle": 1}  # 6·C(512, 3) > 2^24; K4: test_slashburn_dist's case


def distinct_pattern(rc):
    """The simple symmetric pattern of a reference CSR: repeats and
    self-loops dropped."""
    indptr, col = np.asarray(rc.indptr), np.asarray(rc.indices).astype(np.int64)
    row = np.repeat(np.arange(rc.nrows), np.diff(indptr))
    keep = row != col
    return csr_of(row[keep], col[keep], rc.shape)


@pytest.mark.parametrize("name", UNDIRECTED)
def test_triangle_count_equals_jax_on_both_rings(meshes, cache, name):
    rc, rs, ps = sharded(cache, meshes, name)
    rmesh, pmesh = meshes
    dense = ring.triangle_count(ps, pmesh)
    assert isinstance(dense, int) and dense == ref_ring.triangle_count(rs, rmesh)
    if name == "k512" and pmesh.size != 8:
        return  # the sparse ring's 134M candidates run once, on JAX's 8-device mesh
    sparse = ring.triangle_count_sparse(ps, pmesh)
    assert isinstance(sparse, int) and sparse == ref_ring.triangle_count_sparse(rs, rmesh)
    if name in SIMPLE:
        assert sparse == dense == (TRIANGLES[name] if name in TRIANGLES else ref_undirected_count(rc))
    if name == "loops":
        assert sparse == dense == 1
    if name == "multiset":  # the repeated entries count again on the sparse ring only
        assert sparse > dense == ref_undirected_count(distinct_pattern(rc))


@pytest.mark.parametrize("name", DIRECTED)
def test_directed_triangle_count_equals_jax(meshes, cache, name):
    rc, rs, ps = sharded(cache, meshes, name)
    rmesh, pmesh = meshes
    got = ring.triangle_count(ps, pmesh, directed=True)
    assert got == ref_ring.triangle_count(rs, rmesh, directed=True)
    if name.startswith("dir") or name == "k4":
        assert got == ref_directed_count(rc)


@pytest.mark.parametrize("name", JACCARD)
def test_jaccard_weights_equal_jax_on_both_rings(meshes, cache, name):
    rc, rs, ps = sharded(cache, meshes, name)
    rmesh, pmesh = meshes
    dense, sparse = ring.jaccard_weights(ps, pmesh), ring.jaccard_weights_sparse(ps, pmesh)
    assert_padded_equal(dense, ref_ring.jaccard_weights(rs, rmesh), ps)
    assert_padded_equal(sparse, ref_ring.jaccard_weights_sparse(rs, rmesh), ps)
    flat = ring.jaccard_flat(ps, pmesh)
    assert flat.dtype == torch.float32 and flat.device == CPU
    np.testing.assert_array_equal(flat.numpy(), ref_ring.jaccard_flat(rs, rmesh))
    if name in ("sym0", "sym2", "dir0", "dir1"):  # simple graphs: the host's weights
        np.testing.assert_allclose(flat.numpy(), ref_jaccard_host(rc), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(torch.cat([t[:c] for t, c in zip(sparse, ps.nnz_counts)]).numpy(),
                                      flat.numpy())


@pytest.mark.parametrize("name", ("sym0", "k512", "multiset", "rect"))
def test_sparse_sizes_equal_jax(meshes, cache, name):
    rc, rs, ps = sharded(cache, meshes, name)
    assert ring._sparse_sizes(ps, meshes[1]) == ref_ring._sparse_sizes(rs, meshes[0])


def test_past_the_dense_guard_routes_to_the_sparse_ring(meshes, cache, monkeypatch):
    """With ``MAX_DENSE_ELEMS`` at 1 on both packages the undirected count
    and the weights take the sparse ring and the directed count raises."""
    rc, rs, ps = sharded(cache, meshes, "multiset")
    rmesh, pmesh = meshes
    monkeypatch.setattr(ref_ring, "MAX_DENSE_ELEMS", 1)
    monkeypatch.setattr(ring, "MAX_DENSE_ELEMS", 1)
    want = ref_ring.triangle_count(rs, rmesh)
    assert ring.triangle_count(ps, pmesh) == want == ref_ring.triangle_count_sparse(rs, rmesh)
    assert_padded_equal(ring.jaccard_weights(ps, pmesh), ref_ring.jaccard_weights(rs, rmesh), ps)
    np.testing.assert_array_equal(ring.jaccard_flat(ps, pmesh).numpy(), ref_ring.jaccard_flat(rs, rmesh))
    with pytest.raises(ValueError, match="directed") as err:
        ring.triangle_count(ps, pmesh, directed=True)
    with pytest.raises(ValueError) as ref_err:
        ref_ring.triangle_count(rs, rmesh, directed=True)
    assert str(err.value) == str(ref_err.value)


def test_the_guard_counts_cells_per_shard(meshes, cache, monkeypatch):
    """At exactly ``rows·d·rows`` cells the dense ring runs; one fewer and
    the sparse ring does (the multiset graph tells them apart)."""
    rc, rs, ps = sharded(cache, meshes, "multiset")
    pmesh = meshes[1]
    cells = ps.rows_per_shard ** 2 * ps.n_shards
    dense, sparse = ring.triangle_count(ps, pmesh), ring.triangle_count_sparse(ps, pmesh)
    assert dense != sparse
    monkeypatch.setattr(ring, "MAX_DENSE_ELEMS", cells)
    assert ring.triangle_count(ps, pmesh) == dense
    monkeypatch.setattr(ring, "MAX_DENSE_ELEMS", cells - 1)
    assert ring.triangle_count(ps, pmesh) == sparse


def test_a_mesh_that_does_not_hold_the_shards_raises(cache):
    meshes = (ref_make_mesh(4), make_mesh(devices=["cpu"] * 4))
    _, _, ps = sharded(cache, meshes, "k4")
    with pytest.raises(ValueError, match="not on the mesh"):
        ring.triangle_count(ps, make_mesh(devices=["cpu"] * 8))
