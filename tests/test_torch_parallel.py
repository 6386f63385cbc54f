"""Port parity for the distributed tier (``parallel/{mesh,collectives,
sharded,dist}.py``, ``MeshContext``, the mesh edges of the conversion graph,
``interop`` of the sharded containers), on the CPU.

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py`` gives
(``make_mesh(4|8)``); the port on meshes that name the CPU 4 or 8 times
(``make_mesh(devices=["cpu"] * d)``). Graphs are numpy arrays from a seed.
Every container field, padded width, halo list and replicated result must
equal the JAX package exactly, except: the SpMV (rtol 1e-5, atol 1e-5: two
float32 sums of the same terms in different orders); the profile (rtol 1e-6
against the JAX float32 sum, exactly against the host ``Profile``); and the
entries of duplicate (row, col) pairs, whose order the JAX sorts leave
undefined (compared in canonical order). Each JAX distributed function
compiles once per shape, so the cases share a few graphs.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import sparsebase_tpu as ref  # noqa: E402
from sparsebase_tpu.bases import ReorderBase as RefReorderBase  # noqa: E402
from sparsebase_tpu.convert import coo_to_csr as ref_coo_to_csr  # noqa: E402
from sparsebase_tpu.parallel import ShardedCSR as RefShardedCSR  # noqa: E402
from sparsebase_tpu.parallel import dist as ref_dist  # noqa: E402
from sparsebase_tpu.parallel import make_mesh as ref_make_mesh  # noqa: E402
from sparsebase_tpu.parallel import sharded as ref_sharded  # noqa: E402

import fixture as fx  # noqa: E402
import sparsebase_tpu_torch as sbt  # noqa: E402
from sparsebase_tpu_torch import COO, CSR, MeshContext, ReorderBase  # noqa: E402
from sparsebase_tpu_torch.interop import from_reference, to_numpy  # noqa: E402
from sparsebase_tpu_torch.ops.feature.structure import Bandwidth, Profile  # noqa: E402
from sparsebase_tpu_torch.parallel import (  # noqa: E402
    Placement,
    ShardedCSR,
    balanced_row_order,
    collectives,
    dist,
    make_mesh,
    make_mesh_2d,
    replicated,
    shard_rows,
)
from sparsebase_tpu_torch.parallel import sharded as port_sharded  # noqa: E402
from sparsebase_tpu_torch.utils.exceptions import ConversionError, TypeMismatchError  # noqa: E402

CPU = torch.device("cpu")
SHARDS = (4, 8)
FIELDS = ("indptr", "indices", "vals", "nnz_local", "halo_send", "halo_counts", "halo_map")


@pytest.fixture(scope="module", params=SHARDS, ids=lambda d: f"d{d}")
def meshes(request):
    """``(JAX mesh, port mesh)`` of d shards."""
    d = request.param
    assert len(jax.devices()) >= d, "conftest must provide 8 virtual devices"
    return ref_make_mesh(d), make_mesh(devices=["cpu"] * d)


def random_csr(seed, n=64, avg_deg=5, with_vals=True, dedup=True):
    """A reference CSR of seeded random entries (deduplicated unless asked)."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n, n * avg_deg).astype(np.int64)
    col = rng.integers(0, n, n * avg_deg).astype(np.int64)
    if dedup:
        keys = np.unique(row * n + col)
        row, col = keys // n, keys % n
    else:
        order = np.lexsort((col, row))
        row, col = row[order], col[order]
    vals = rng.standard_normal(len(row)).astype(np.float32) if with_vals else None
    return ref_coo_to_csr(ref.COO.new(row.astype(np.int32), col.astype(np.int32), vals, shape=(n, n)))


def path_csr(n):
    row = np.concatenate([np.arange(n - 1), np.arange(1, n)]).astype(np.int32)
    col = np.concatenate([np.arange(1, n), np.arange(n - 1)]).astype(np.int32)
    return ref_coo_to_csr(ref.COO.new(row, col, None, shape=(n, n)))


def zipf_csr(n=20000, nz=200000, seed=1):
    rng = np.random.default_rng(seed)
    zr = rng.zipf(1.3, nz) - 1
    zr = zr[zr < n].astype(np.int64)
    zc = rng.integers(0, n, len(zr)).astype(np.int64)
    keys = np.unique(zr * n + zc)
    return ref_coo_to_csr(ref.COO.new((keys // n).astype(np.int32), (keys % n).astype(np.int32), None, shape=(n, n)))


def assert_same_container(port, want, fields=FIELDS):
    """Every field of the port's container equals the JAX container's array,
    shape included."""
    got = to_numpy(port)
    assert got["shape"] == tuple(want._shape)
    for name in fields:
        a = getattr(want, name)
        if a is None:
            assert got[name] is None, name
            continue
        a = np.asarray(a)
        assert got[name].shape == a.shape, (name, got[name].shape, a.shape)
        np.testing.assert_array_equal(got[name], a, err_msg=name)


@pytest.fixture(scope="module")
def graph(meshes):
    """A seeded random graph (n = 64, 5 entries a row, deduplicated) in both
    packages on both meshes: ``(ref mesh, port mesh, ref csr, port csr, ref
    sharded, port sharded)``."""
    rmesh, pmesh = meshes
    rc = random_csr(0)
    pc = from_reference(rc, CPU)
    return rmesh, pmesh, rc, pc, RefShardedCSR.from_csr(rc, rmesh), ShardedCSR.from_csr(pc, pmesh)


# -- the mesh, the placements and MeshContext ------------------------------------
class TestMesh:
    def test_make_mesh_raises_without_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for call in (lambda: make_mesh(), lambda: make_mesh(4), lambda: make_mesh_2d((2, 2))):
            with pytest.raises(RuntimeError, match="no CUDA card"):
                call()

    def test_make_mesh_raises_past_the_visible_cards(self, monkeypatch):
        # JAX gives a smaller mesh; the port raises
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        assert make_mesh().devices.tolist() == [torch.device("cuda", 0), torch.device("cuda", 1)]
        with pytest.raises(RuntimeError, match="4 devices asked for, 2"):
            make_mesh(4)

    def test_explicit_devices_may_repeat(self):
        mesh = make_mesh(devices=["cpu"] * 4, axis="r")
        assert mesh.shape == {"r": 4} and mesh.size == 4 and mesh.axis_devices("r") == (CPU,) * 4
        assert mesh == make_mesh(devices=[CPU] * 4, axis="r") and mesh != make_mesh(devices=[CPU] * 4)
        with pytest.raises(ValueError):
            make_mesh(3, devices=["cpu"] * 4)
        grid = make_mesh_2d((2, 4), ("a", "b"), devices=["cpu"] * 8)
        assert grid.shape == {"a": 2, "b": 4} and grid.devices.shape == (2, 4)
        assert len(grid.axis_devices("b")) == 4 and len(grid.axis_devices("a")) == 2

    def test_placements(self):
        mesh = make_mesh(devices=["cpu"] * 4)
        t = torch.arange(8)
        pieces = shard_rows(mesh).put(t)
        assert [p.tolist() for p in pieces] == [[0, 1], [2, 3], [4, 5], [6, 7]]
        assert all(p.data_ptr() == t.data_ptr() for p in replicated(mesh).put(t))  # shared, not copied
        assert isinstance(shard_rows(mesh), Placement) and replicated(mesh).axis is None
        with pytest.raises(ValueError):
            shard_rows(mesh).put(torch.arange(6))

    def test_mesh_context(self):
        mesh = make_mesh(devices=["cpu"] * 4)
        ctx = MeshContext(mesh, "x")
        assert ctx.is_equivalent(MeshContext(make_mesh(devices=["cpu"] * 4), "x"))
        assert not ctx.is_equivalent(MeshContext(mesh, "y")) and not ctx.is_equivalent(sbt.HostContext())
        assert ctx.devices == (CPU,) * 4
        assert sbt.MeshContext is MeshContext and "MeshContext" in sbt.__all__
        sh = ShardedCSR.from_csr(from_reference(random_csr(1, n=20), CPU), mesh)
        assert sbt.context_of(sh) == sh.context and sh.context.is_equivalent(ctx)


# -- the collectives on their own ---------------------------------------------------
class TestCollectives:
    def test_reductions(self):
        parts = [torch.tensor([1, -2, 3]) * (k + 1) for k in range(4)]
        assert all(p.tolist() == [10, -20, 30] for p in collectives.psum(parts))
        assert all(p.tolist() == [4, -2, 12] for p in collectives.pmax(parts))
        assert all(p.tolist() == [1, -8, 3] for p in collectives.pmin(parts))
        # float sums in shard order 0..d-1
        f = [torch.tensor([1e8], dtype=torch.float32), torch.tensor([1.0]), torch.tensor([-1e8]), torch.tensor([1.0])]
        want = ((np.float32(1e8) + np.float32(1.0)) - np.float32(1e8)) + np.float32(1.0)
        assert collectives.psum(f)[0].item() == want
        out = collectives.psum(parts)
        assert all(o.data_ptr() == out[0].data_ptr() for o in out)  # one device: one result

    @pytest.mark.parametrize("split,concat", [(0, 0), (0, 1), (1, 0), (1, 1)])
    def test_all_to_all(self, split, concat):
        d = 4
        parts = [torch.arange(d * d * 2).reshape(d * (2 if split == 0 else 1), -1) + 100 * s for s in range(d)]
        got = collectives.all_to_all(parts, split, concat)
        for r in range(d):
            want = torch.cat([p.tensor_split(d, dim=split)[r] for p in parts], dim=concat)
            assert torch.equal(got[r], want)
        with pytest.raises(ValueError):
            collectives.all_to_all([torch.arange(6)] * 4)

    def test_psum_scatter(self):
        parts = [torch.arange(8.0) * (k + 1) for k in range(4)]
        total = sum(parts)
        got = collectives.psum_scatter(parts)
        assert [g.tolist() for g in got] == [total[2 * r : 2 * r + 2].tolist() for r in range(4)]
        flat = collectives.psum_scatter([torch.arange(4.0)] * 4, tiled=False)
        assert [g.shape for g in flat] == [torch.Size([])] * 4 and [g.item() for g in flat] == [0.0, 4.0, 8.0, 12.0]
        with pytest.raises(ValueError):
            collectives.psum_scatter([torch.arange(6.0)] * 4)


# -- ShardedCSR ---------------------------------------------------------------------------
class TestShardedCSR:
    def test_from_csr_equals_jax(self, graph):
        rmesh, pmesh, rc, pc, rs, ps = graph
        assert_same_container(ps, rs)
        assert ps.halo_width == rs.halo_width and ps.nnz == rs.nnz == rc.nnz
        assert ps.padded_width_ratio() == rs.padded_width_ratio()
        assert ps.halo_bytes_per_exchange == rs.halo_bytes_per_exchange
        assert repr(ps) == repr(rs)
        assert [ps.local_row_offset(k) for k in range(4)] == [rs.local_row_offset(k) for k in range(4)]

    def test_roundtrip(self, graph):
        rmesh, pmesh, rc, pc, rs, ps = graph
        back = ps.to_csr()
        assert back.indptr.device == ps.devices[0]
        for name in ("indptr", "indices", "vals"):
            assert torch.equal(getattr(back, name), getattr(pc, name)), name
        fixture = from_reference(fx.make_csr(), CPU)
        fx.compare_csr(fx.make_csr(), ShardedCSR.from_csr(fixture, pmesh).to_csr().to_host())

    def test_sharding_layout(self, graph):
        rmesh, pmesh, rc, pc, rs, ps = graph
        d = pmesh.shape["x"]
        assert ps.n_shards == d and ps.devices == pmesh.axis_devices("x") and ps.mesh == pmesh
        assert ps.stacked("indices").shape == np.asarray(rs.indices).shape
        assert len(ps._tensors()) == 7 * d
        moved = ps.to(MeshContext(make_mesh(devices=["cpu"] * d, axis="r"), "r"))
        assert moved.axis == "r" and all(torch.equal(a, b) for a, b in zip(moved.indices, ps.indices))

    @pytest.mark.parametrize("seed,n,deg", [(0, 64, 5), (1, 40, 3), (2, 96, 7), (3, 17, 2), (4, 8, 1)])
    def test_with_halo_matches_host_builder(self, meshes, seed, n, deg):
        rmesh, pmesh = meshes
        rc = random_csr(seed, n=n, avg_deg=deg)
        base = ShardedCSR.from_csr(from_reference(rc, CPU), pmesh, halo=False)
        dev = base.with_halo()
        li, nl = base.stacked("indices").numpy(), np.asarray(base.nnz_counts)
        want = ref_sharded._build_halo(li, nl, base.rows_per_shard, base.n_shards)
        for got, name, w in zip(port_sharded._build_halo(li, nl, base.rows_per_shard, base.n_shards),
                                ("halo_send", "halo_counts", "halo_map"), want):
            np.testing.assert_array_equal(got, w)  # the port's oracle is the JAX one
            np.testing.assert_array_equal(dev.stacked(name).numpy(), w, err_msg=name)
        assert dev.halo_width == want[0].shape[2] and dev.with_halo() is dev

    def test_with_halo_equals_the_jax_device_pass(self, graph):
        rmesh, pmesh, rc, pc, rs, ps = graph
        want = RefShardedCSR.from_csr(rc, rmesh, halo=False).with_halo()
        assert_same_container(ShardedCSR.from_csr(pc, pmesh, halo=False).with_halo(), want)

    # each case compiles the JAX shard_map body anew (several seconds): one mesh size per case
    @pytest.mark.parametrize("d,dedup,with_vals", [(4, True, True), (4, False, True), (8, False, False)],
                             ids=["d4-valued", "d4-duplicates", "d8-pattern"])
    def test_from_coo_sharded_equals_jax(self, d, dedup, with_vals):
        rmesh, pmesh = ref_make_mesh(d), make_mesh(devices=["cpu"] * d)
        rc = random_csr(5, n=72, avg_deg=4, with_vals=with_vals, dedup=dedup)
        coo = rc.convert(ref.COO)
        rng = np.random.default_rng(6)
        perm = rng.permutation(rc.nnz)  # entries in any order
        row, col = np.asarray(coo.row)[perm], np.asarray(coo.col)[perm]
        vals = None if coo.vals is None else np.asarray(coo.vals)[perm]
        want = RefShardedCSR.from_coo_sharded(jnp.asarray(row), jnp.asarray(col),
                                              None if vals is None else jnp.asarray(vals), rc.shape, rmesh)
        stats = {}
        got = ShardedCSR.from_coo_sharded(torch.as_tensor(row), torch.as_tensor(col),
                                          None if vals is None else torch.as_tensor(vals), rc.shape, pmesh,
                                          stats=stats)
        rows, e = -(-rc.nrows // d), -(-rc.nnz // d)
        padded = np.concatenate([row, np.full(d * e - rc.nnz, rc.nrows, np.int32)])
        load = int(np.asarray(ref_sharded._route_counts_runner(rmesh, "x", d, rows, e, rc.nrows)(
            jnp.asarray(padded))).reshape(-1)[0])
        assert stats["route_capacity"] == max(64, 1 << (max(load, 1) - 1).bit_length())
        assert stats["compacted_width"] == got.width == np.asarray(want.indices).shape[1]
        assert_same_container(got, want, ("indptr", "nnz_local"))
        g, w = to_numpy(got), {name: np.asarray(getattr(want, name)) for name in ("indices", "vals")
                               if getattr(want, name) is not None}
        assert (g["vals"] is None) == ("vals" not in w)
        for k in range(d):  # canonical order within duplicate (row, col) runs
            cnt = int(g["nnz_local"][k])
            lrow = np.repeat(np.arange(rows), np.diff(g["indptr"][k]))
            for side in (g, w):
                v = side["vals"][k, :cnt] if "vals" in side and side["vals"] is not None else np.zeros(cnt)
                order = np.lexsort((v, side["indices"][k, :cnt], lrow))
                side.setdefault("canon", []).append((side["indices"][k, :cnt][order], v[order]))
            np.testing.assert_array_equal(g["canon"][k][0], w["canon"][k][0])
            np.testing.assert_array_equal(g["canon"][k][1], w["canon"][k][1])
            np.testing.assert_array_equal(g["indices"][k, cnt:], w["indices"][k, cnt:])

    # (n, nnz, d): pad rows owned by a shard before the last (n = 5, d = 4),
    # blocks that are all padding, one entry, none
    @pytest.mark.parametrize("n,nnz,d", [(5, 5, 4), (5, 3, 4), (10, 7, 4), (1, 1, 8), (3, 0, 4), (9, 2, 8)])
    def test_from_coo_sharded_at_edge_shapes(self, n, nnz, d):
        rng = np.random.default_rng(n * 100 + nnz)
        row, col = (torch.as_tensor(rng.integers(0, n, nnz), dtype=torch.int32) for _ in range(2))
        vals = torch.as_tensor(rng.standard_normal(nnz), dtype=torch.float32)
        mesh = make_mesh(devices=["cpu"] * d)
        got = ShardedCSR.from_coo_sharded(row, col, vals, (n, n), mesh).with_halo()
        csr = COO.new(row, col, vals, (n, n)).convert(CSR)
        want = ShardedCSR.from_csr(csr, mesh)
        assert got.nnz_counts == want.nnz_counts and got.width == max(64, want.width)
        for name in ("indptr", "halo_send", "halo_counts"):
            assert torch.equal(got.stacked(name), want.stacked(name)), name
        back = got.to_csr()
        assert torch.equal(back.indptr, csr.indptr) and torch.equal(back.indices, csr.indices)

    def test_from_coo_sharded_capacity_overflow(self, meshes):
        rmesh, pmesh = meshes
        coo = random_csr(5, n=72, avg_deg=4).convert(ref.COO)
        row, col, vals = (np.asarray(a) for a in (coo.row, coo.col, coo.vals))
        with pytest.raises(ValueError, match="overflow"):
            ShardedCSR.from_coo_sharded(torch.as_tensor(row), torch.as_tensor(col), torch.as_tensor(vals),
                                        coo.shape, pmesh, route_capacity=2)
        fits = ShardedCSR.from_coo_sharded(torch.as_tensor(row), torch.as_tensor(col), torch.as_tensor(vals),
                                           coo.shape, pmesh, route_capacity=coo.nnz)
        assert fits.nnz == coo.nnz

    def test_ingest_then_halo(self, graph):
        rmesh, pmesh, rc, pc, rs, ps = graph
        coo = pc.convert(COO)
        sh = ShardedCSR.from_coo_sharded(coo.row, coo.col, coo.vals, pc.shape, pmesh).with_halo()
        for name in ("indptr", "nnz_local", "halo_send", "halo_counts"):
            assert torch.equal(sh.stacked(name), ps.stacked(name)), name
        for k in range(sh.n_shards):
            cnt = sh.nnz_counts[k]
            assert torch.equal(sh.halo_map[k][:cnt], ps.halo_map[k][:cnt])
        x = torch.randn(pc.ncols, generator=torch.Generator().manual_seed(0))
        torch.testing.assert_close(dist.spmv(sh, x, pmesh), dist.spmv(ps, x, pmesh), rtol=1e-5, atol=1e-5)

    def test_interop_carries_the_fields(self, graph):
        rmesh, pmesh, rc, pc, rs, ps = graph
        carried = from_reference(rs, pmesh)
        assert isinstance(carried, ShardedCSR) and carried.devices == pmesh.axis_devices("x")
        assert carried.indptr[0].dtype == torch.int64 and carried.indices[0].dtype == torch.int32
        assert carried.nnz_local[0].shape == () and carried.halo_send[0].shape == (ps.n_shards, ps.halo_width)
        assert_same_container(carried, rs)
        assert_same_container(ps, rs)
        with pytest.raises(TypeMismatchError):
            from_reference(rs, make_mesh(devices=["cpu"] * 2))


# -- nnz-balanced row blocks ----------------------------------------------------------
class TestSentinelRows:
    """ROADMAP.md §3, fault 3.5: ``from_coo_sharded`` given rows equal to n
    and past it. JAX routes each as the pad row n from its own row block: it
    fills a bucket slot and counts toward the loads and the capacity, never
    toward a shard's entries, the compacted width or the local sort. The
    port's container, capacity, width and halo lists equal JAX's; the values
    of the true entries are compared in canonical order (the tail past them
    holds whatever JAX's unstable sort left there)."""

    # (n, d): the repro of ROADMAP.md §3 (n = 40), and n = 5 on 4 shards,
    # whose row n lies in shard 2's block and the rows past it in shard 3's.
    # Half the sentinel rows are n, half past it
    @pytest.mark.parametrize("n,d", [(40, 4), (40, 8), (5, 4)])
    def test_equals_jax(self, n, d):
        rng = np.random.default_rng(0)
        row, col = rng.integers(0, n, 300), rng.integers(0, n, 300)
        vals = rng.random(300).astype(np.float32)
        sentinel = rng.random(300) < 0.3
        row[sentinel] = n
        past = sentinel & (rng.random(300) < 0.5)
        row[past] += rng.integers(1, 3 * n, int(past.sum()))
        rmesh, pmesh = ref_make_mesh(d), make_mesh(devices=["cpu"] * d)
        want = RefShardedCSR.from_coo_sharded(jnp.asarray(row, jnp.int32), jnp.asarray(col, jnp.int32),
                                              jnp.asarray(vals), (n, n), rmesh).with_halo()
        stats = {}
        got = ShardedCSR.from_coo_sharded(torch.as_tensor(row), torch.as_tensor(col), torch.as_tensor(vals), (n, n),
                                          pmesh, stats=stats).with_halo()
        rows, e = -(-n // d), -(-300 // d)
        load = int(np.asarray(ref_sharded._route_counts_runner(rmesh, "x", d, rows, e, n)(
            jnp.asarray(np.r_[row, np.full(d * e - 300, n)].astype(np.int32)))).reshape(-1)[0])
        assert stats["route_capacity"] == max(64, 1 << (max(load, 1) - 1).bit_length())
        assert stats["compacted_width"] == got.width == np.asarray(want.indices).shape[1]
        assert got.nnz_counts == tuple(np.asarray(want.nnz_local).tolist())
        assert sum(got.nnz_counts) == int((row < n).sum())
        assert_same_container(got, want, ("indptr", "indices", "nnz_local", "halo_send", "halo_counts"))
        g, w = to_numpy(got), {name: np.asarray(getattr(want, name)) for name in ("vals", "halo_map")}
        for k in range(d):
            cnt = got.nnz_counts[k]
            np.testing.assert_array_equal(g["halo_map"][k, :cnt], w["halo_map"][k, :cnt])
            lrow = np.repeat(np.arange(rows), np.diff(g["indptr"][k]))
            order = np.lexsort((g["vals"][k, :cnt], g["indices"][k, :cnt], lrow))
            want_order = np.lexsort((w["vals"][k, :cnt], g["indices"][k, :cnt], lrow))
            np.testing.assert_array_equal(g["vals"][k, :cnt][order], w["vals"][k, :cnt][want_order])
        back, kept = got.to_csr(), row < n
        want_csr = COO.new(torch.as_tensor(row[kept]), torch.as_tensor(col[kept]), None, (n, n)).convert(CSR)
        assert torch.equal(back.indptr, want_csr.indptr) and torch.equal(back.indices, want_csr.indices)


class TestBalancedSharding:
    @pytest.mark.parametrize("n", [20000, 20005])
    @pytest.mark.parametrize("d", SHARDS)
    def test_order_equals_jax(self, n, d):
        rc = zipf_csr(n=n, seed=1 if n == 20000 else 2)
        want = ref_sharded.balanced_row_order(rc, d)
        got = balanced_row_order(from_reference(rc, CPU), d)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)

    def test_from_csr_balanced_equals_jax(self, meshes):
        rmesh, pmesh = meshes
        rc = zipf_csr(n=4000, nz=40000, seed=3)
        pc = from_reference(rc, CPU)
        want, want_order = RefShardedCSR.from_csr_balanced(rc, rmesh, halo=True)
        got, order = ShardedCSR.from_csr_balanced(pc, pmesh, halo=True)
        np.testing.assert_array_equal(order.numpy(), want_order)
        assert_same_container(got, want)
        plain = ShardedCSR.from_csr(pc, pmesh, halo=False)
        assert got.padded_width_ratio() == want.padded_width_ratio() < plain.padded_width_ratio()
        # degrees of the permuted container map back through the order
        assert torch.equal(dist.degrees(got, pmesh)[order], pc.degrees())

    def test_balanced_spmv(self, meshes):
        rmesh, pmesh = meshes
        pc = from_reference(zipf_csr(), CPU)
        got, order = ShardedCSR.from_csr_balanced(pc, pmesh, halo=False)
        assert got.padded_width_ratio() <= 2.0 < ShardedCSR.from_csr(pc, pmesh, halo=False).padded_width_ratio()
        x = torch.randn(pc.ncols, generator=torch.Generator().manual_seed(1))
        x_new = torch.empty_like(x)
        x_new[order] = x
        y = dist.spmv(got, x_new, pmesh)
        dense = torch.zeros(pc.shape).index_put_((pc.row_of_nnz().long(), pc.indices.long()), torch.ones(pc.nnz),
                                                  accumulate=True)
        torch.testing.assert_close(y[order], dense @ x, rtol=1e-4, atol=1e-4)


# -- the distributed functions ---------------------------------------------------------
class TestDistributedOps:
    def test_spmv(self, graph):
        rmesh, pmesh, rc, pc, rs, ps = graph
        x = np.random.default_rng(1).standard_normal(rc.ncols).astype(np.float32)
        want = np.asarray(ref_dist.spmv(rs, jnp.asarray(x), rmesh))
        got = dist.spmv(ps, torch.as_tensor(x), pmesh)
        assert got.shape == (rc.nrows,) and got.device == CPU
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(rc.to_dense()) @ x, rtol=1e-4, atol=1e-4)
        # power-iteration style: two products
        y = dist.spmv(ps, dist.spmv(ps, torch.ones(rc.ncols), pmesh), pmesh)
        assert y.shape == (rc.nrows,) and bool(torch.isfinite(y).all())

    def test_degrees_and_degree_reorder(self, graph):
        rmesh, pmesh, rc, pc, rs, ps = graph
        np.testing.assert_array_equal(dist.degrees(ps, pmesh).numpy(), np.asarray(ref_dist.degrees(rs, rmesh)))
        for ascending in (True, False):
            got = dist.degree_reorder(ps, pmesh, ascending=ascending)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref_dist.degree_reorder(rs, rmesh, ascending)))
        fx.check_degree_ordering(dist.degree_reorder(ps, pmesh).numpy(), pc.indptr.numpy())

    def test_bfs_and_rcm_on_the_random_graph(self, graph):
        rmesh, pmesh, rc, pc, rs, ps = graph
        stats = {}
        levels = dist.bfs_levels(ps, 0, pmesh, stats=stats)
        np.testing.assert_array_equal(levels.numpy(), np.asarray(ref_dist.bfs_levels(rs, 0, rmesh)))
        assert stats == {"levels": int(levels.max()) + 1, "host_reads": int(levels.max()) + 2}
        np.testing.assert_array_equal(dist.rcm_reorder(ps, pmesh).numpy(), np.asarray(ref_dist.rcm_reorder(rs, rmesh)))

    @pytest.mark.parametrize("case", ["path", "disconnected", "random-pattern"])
    def test_bfs_and_rcm_by_graph(self, case):
        rmesh, pmesh = ref_make_mesh(8), make_mesh(devices=["cpu"] * 8)
        if case == "path":
            rc = path_csr(32)
        elif case == "disconnected":
            rc = ref_coo_to_csr(ref.COO.new(np.array([0, 1], np.int32), np.array([1, 0], np.int32), None, shape=(8, 8)))
        else:
            rc = random_csr(7, n=48, avg_deg=2, with_vals=False)
        rs, ps = RefShardedCSR.from_csr(rc, rmesh), ShardedCSR.from_csr(from_reference(rc, CPU), pmesh)
        levels = dist.bfs_levels(ps, 0, pmesh)
        np.testing.assert_array_equal(levels.numpy(), np.asarray(ref_dist.bfs_levels(rs, 0, rmesh)))
        order = dist.rcm_reorder(ps, pmesh, root=0)
        np.testing.assert_array_equal(order.numpy(), np.asarray(ref_dist.rcm_reorder(rs, rmesh, root=0)))
        fx.check_reorder(order.numpy(), rc.nrows)
        if case == "path":
            assert levels.tolist() == list(range(32))
            row, col = np.asarray(rc.convert(ref.COO).row), np.asarray(rc.indices)
            assert np.abs(order.numpy()[row] - order.numpy()[col]).max() == 1
        if case == "disconnected":
            assert levels[:2].tolist() == [0, 1] and bool((levels[2:] == -1).all())
        capped = dist.bfs_levels(ps, 0, pmesh, max_iters=2)
        np.testing.assert_array_equal(capped.numpy(), np.asarray(ref_dist.bfs_levels(rs, 0, rmesh, max_iters=2)))

    def test_label_prop_and_edge_cut(self, graph):
        rmesh, pmesh, rc, pc, rs, ps = graph
        got = dist.label_prop_partition(ps, 4, pmesh, num_iters=8)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref_dist.label_prop_partition(rs, 4, rmesh, num_iters=8)))
        fx.check_partition(got.numpy(), rc.nrows, 4)
        labels = np.random.default_rng(2).integers(0, 3, rc.nrows).astype(np.int32)
        cut = dist.edge_cut(ps, torch.as_tensor(labels), pmesh)
        assert int(cut) == int(ref_dist.edge_cut(rs, jnp.asarray(labels), rmesh))
        row = np.repeat(np.arange(rc.nrows), np.diff(np.asarray(rc.indptr)))
        assert int(cut) == int((labels[row] != labels[np.asarray(rc.indices)]).sum())

    def test_mesh_must_hold_the_shards(self, graph):
        rmesh, pmesh, rc, pc, rs, ps = graph
        other = make_mesh(devices=["cpu"] * (12 - pmesh.shape["x"]))
        with pytest.raises(ValueError, match="not on the mesh"):
            dist.degrees(ps, other)


class TestMoreColumnsThanRows:
    """ROADMAP.md §3, fault 3.4: a sharded matrix with more columns than rows.
    The JAX BFS scatter drops the columns past n, its label gather clamps
    them to n - 1; the port does the same and returns JAX's results."""

    @staticmethod
    def rect(seed):
        if seed is None:  # the repro of ROADMAP.md §3
            row, col, shape = np.array([0, 1, 2, 5, 9]), np.array([1, 12, 0, 14, 3]), (10, 15)
        else:
            rng = np.random.default_rng(seed)
            shape = (30, 30 + 17 * seed)
            row, col = rng.integers(0, shape[0], 90), rng.integers(0, shape[1], 90)
        keys = np.unique(row.astype(np.int64) * shape[1] + col)
        return ref_coo_to_csr(ref.COO.new((keys // shape[1]).astype(np.int32), (keys % shape[1]).astype(np.int32),
                                          None, shape=shape))

    @pytest.mark.parametrize("seed", [None, 1, 2], ids=["repro", "rand1", "rand2"])
    def test_bfs_rcm_and_label_prop_equal_jax(self, meshes, seed):
        rmesh, pmesh = meshes
        rc = self.rect(seed)
        rs, ps = RefShardedCSR.from_csr(rc, rmesh), ShardedCSR.from_csr(from_reference(rc, CPU), pmesh)
        levels = dist.bfs_levels(ps, 0, pmesh)
        order = dist.rcm_reorder(ps, pmesh)
        labels = dist.label_prop_partition(ps, 2, pmesh)
        np.testing.assert_array_equal(levels.numpy(), np.asarray(ref_dist.bfs_levels(rs, 0, rmesh)))
        np.testing.assert_array_equal(order.numpy(), np.asarray(ref_dist.rcm_reorder(rs, rmesh)))
        np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_dist.label_prop_partition(rs, 2, rmesh)))
        fx.check_reorder(order.numpy(), rc.nrows)
        if seed is None:
            assert levels.tolist() == [0, 1] + [-1] * 8
            assert order.tolist() == [1, 0, 7, 2, 3, 8, 4, 5, 6, 9]
            assert labels.tolist() == [0, 0, 1, 0, 0, 0, 1, 1, 1, 0]


class TestRefinePartition:
    def test_equals_jax_and_reduces_edge_cut(self):
        rmesh, pmesh = ref_make_mesh(8), make_mesh(devices=["cpu"] * 8)
        rc = random_csr(8, n=96, avg_deg=6)
        rs, ps = RefShardedCSR.from_csr(rc, rmesh), ShardedCSR.from_csr(from_reference(rc, CPU), pmesh)
        rng = np.random.default_rng(0)
        k = 4
        labels0 = (np.arange(96) * k // 96).astype(np.int32)
        labels0[rng.integers(0, 96, 32)] = rng.integers(0, k, 32)
        want = np.asarray(ref_dist.refine_partition(rs, jnp.asarray(labels0), k, rmesh, rounds=4))
        got = dist.refine_partition(ps, torch.as_tensor(labels0), k, pmesh, rounds=4)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        cut0, cut1 = (int(dist.edge_cut(ps, lab, pmesh)) for lab in (torch.as_tensor(labels0), got))
        assert cut1 <= cut0
        assert np.bincount(got.numpy(), minlength=k).max() <= 1.3 * 96 / k

    def test_float_order_key_orders_as_floats(self):
        f = torch.tensor([float("inf"), -3.5, 0.0, -0.0, 2.0, -float("inf"), 1e-30, -1e-30, 7.0])
        key = dist._float_order_key(f)
        assert bool((key >= 0).all()) and bool((key < 2**32).all())
        assert torch.equal(torch.argsort(key, stable=True), torch.argsort(f, stable=True))


class TestStructureFeatures:
    def test_matches_jax_and_host_features(self, meshes):
        rmesh, pmesh = meshes
        rc = random_csr(9, n=80, avg_deg=4)
        rs, pc = RefShardedCSR.from_csr(rc, rmesh), from_reference(rc, CPU)
        got = dist.structure_features(ShardedCSR.from_csr(pc, pmesh), pmesh)
        want = ref_dist.structure_features(rs, rmesh)
        assert set(got) == set(want)
        for name in ("bandwidth", "nnz", "min_degree", "max_degree", "avg_degree"):
            assert got[name].item() == np.asarray(want[name]).item(), name
        np.testing.assert_allclose(got["profile"].item(), float(want["profile"]), rtol=1e-6)
        assert got["profile"].dtype == torch.int64
        assert int(got["profile"]) == int(Profile().get_profile(pc))
        assert int(got["bandwidth"]) == int(Bandwidth().get_bandwidth(pc))


class TestDistributedHeatmap:
    @pytest.mark.parametrize("order", ["identity", "degree"])
    def test_matches_jax_and_host_heatmap(self, graph, order):
        rmesh, pmesh, rc, pc, rs, ps = graph
        o = (np.arange(rc.nrows, dtype=np.int32) if order == "identity"
             else np.asarray(ref.ops.reorder.DegreeReorder().get_reorder(rc)).astype(np.int32))
        b = 4 if order == "identity" else 3
        got = dist.reorder_heatmap(ps, torch.as_tensor(o), torch.as_tensor(o), pmesh, num_parts=b)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref_dist.reorder_heatmap(rs, o, o, rmesh, num_parts=b)))
        host = ReorderBase.heatmap(pc, torch.as_tensor(o), torch.as_tensor(o), num_parts=b).vals.reshape(b, b)
        np.testing.assert_allclose(got.numpy(), host.numpy(), rtol=1e-6)
        want = np.asarray(RefReorderBase.heatmap(rc, o, o, num_parts=b).vals).reshape(b, b)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


# -- the conversion graph's mesh edges ----------------------------------------------------
class TestMeshConversionEdges:
    def test_csr_to_sharded_via_convert(self, graph):
        rmesh, pmesh, rc, pc, rs, ps = graph
        sh = pc.convert(ShardedCSR, MeshContext(pmesh, "x"))
        assert isinstance(sh, ShardedCSR) and sh.nnz == pc.nnz and sh.has_halo
        assert_same_container(sh, rc.convert(RefShardedCSR, ref.MeshContext(rmesh, "x")))
        back = sh.convert(CSR)
        assert torch.equal(back.indptr, pc.indptr) and torch.equal(back.indices, pc.indices)

    def test_coo_to_sharded_multihop(self, graph):
        rmesh, pmesh, rc, pc, rs, ps = graph
        chain = sbt.convert_cached(pc.convert(COO), ShardedCSR, MeshContext(pmesh, "x"))
        assert [type(f).__name__ for f in chain] == ["CSR", "ShardedCSR"]
        assert chain[-1].nnz == pc.nnz

    def test_unreachable_without_mesh_context(self, graph):
        pc = graph[3]
        with pytest.raises(ConversionError):
            pc.convert(ShardedCSR)
        assert not sbt.can_convert(CSR, ShardedCSR)
        with pytest.raises(TypeMismatchError, match="not a sharded format"):
            pc.to(MeshContext(graph[1], "x"))

    def test_edge_kinds(self):
        from sparsebase_tpu_torch.convert.graph import ContextConversion, EagerConversion, default_graph
        from sparsebase_tpu_torch.formats.ell import ELL

        edges = default_graph()._edges
        assert isinstance(edges[CSR][ShardedCSR][0][1], ContextConversion)
        assert isinstance(edges[ShardedCSR][CSR][0][1], ContextConversion)
        assert isinstance(edges[CSR][ELL][0][1], EagerConversion) and isinstance(edges[ELL][CSR][0][1], EagerConversion)
