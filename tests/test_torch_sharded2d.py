"""Port parity for ``parallel/sharded2d.py`` (``Sharded2DCSR``, ``spmv``,
``degrees``) on the CPU.

The JAX side runs on 2-D meshes of the 8 virtual CPU devices
``tests/conftest.py`` gives; the port on 2-D meshes that name the CPU as
often. The port builds the tiles with array ops (a stable sort by tile,
then each tile's ``indptr``), the JAX package with a loop over rows on the
host: every tile array, padded shape included, must be equal. The SpMV is
held to rtol 1e-5, atol 1e-6 (float32 sums of the same terms in other
orders); the degrees exactly. Graphs are numpy arrays from a seed.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import sparsebase_tpu as ref  # noqa: E402
from sparsebase_tpu.convert import coo_to_csr as ref_coo_to_csr  # noqa: E402
from sparsebase_tpu.parallel import make_mesh_2d as ref_make_mesh_2d  # noqa: E402
from sparsebase_tpu.parallel import sharded2d as ref_sharded2d  # noqa: E402

from sparsebase_tpu_torch import MeshContext  # noqa: E402
from sparsebase_tpu_torch.interop import from_reference, to_numpy  # noqa: E402
from sparsebase_tpu_torch.parallel import Sharded2DCSR, make_mesh_2d, sharded2d  # noqa: E402
from sparsebase_tpu_torch.utils.exceptions import TypeMismatchError  # noqa: E402

CPU = torch.device("cpu")
FIELDS = ("indptr", "indices", "vals", "nnz_local")
# (n, grid, seed): rows padded to a multiple of the columns' count, n not a
# multiple of the grid, one row of tiles wider than tall
CASES = {"72-4x2": (72, (4, 2), 0), "40-2x2": (40, (2, 2), 1), "37-2x4": (37, (2, 4), 2)}


def random_csr(seed, n, avg_deg=5, with_vals=True):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, n, n * avg_deg) * n + rng.integers(0, n, n * avg_deg))
    vals = rng.standard_normal(len(keys)).astype(np.float32) if with_vals else None
    return ref_coo_to_csr(ref.COO.new((keys // n).astype(np.int32), (keys % n).astype(np.int32), vals, shape=(n, n)))


def path_csr(n):
    row = np.concatenate([np.arange(n - 1), np.arange(1, n)]).astype(np.int32)
    col = np.concatenate([np.arange(1, n), np.arange(n - 1)]).astype(np.int32)
    return ref_coo_to_csr(ref.COO.new(row, col, None, shape=(n, n)))


def meshes(grid):
    return ref_make_mesh_2d(grid), make_mesh_2d(grid, devices=["cpu"] * (grid[0] * grid[1]))


def assert_same_tiles(port, want):
    got = to_numpy(port)
    assert got["shape"] == tuple(want._shape)
    for name in FIELDS:
        a = getattr(want, name)
        if a is None:
            assert got[name] is None
            continue
        a = np.asarray(a)
        assert got[name].shape == a.shape, (name, got[name].shape, a.shape)
        np.testing.assert_array_equal(got[name], a, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiles_spmv_and_degrees_equal_jax(case):
    n, grid, seed = CASES[case]
    rmesh, pmesh = meshes(grid)
    rc = random_csr(seed, n)
    rs = ref_sharded2d.Sharded2DCSR.from_csr(rc, rmesh)
    ps = Sharded2DCSR.from_csr(from_reference(rc, CPU), pmesh)
    assert_same_tiles(ps, rs)
    assert ps.grid == rs.grid and ps.rows_per_tile == rs.rows_per_tile and ps.nnz == rs.nnz == rc.nnz
    assert repr(ps) == repr(rs) and ps.mesh == pmesh
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    y = sharded2d.spmv(ps, torch.as_tensor(x), pmesh)
    assert y.shape == (n,) and y.device == CPU
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_sharded2d.spmv(rs, jnp.asarray(x), rmesh)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(rc.to_dense()) @ x, rtol=1e-4, atol=1e-4)
    deg = sharded2d.degrees(ps, pmesh)
    np.testing.assert_array_equal(deg.numpy(), np.asarray(ref_sharded2d.degrees(rs, rmesh)))
    np.testing.assert_array_equal(deg.numpy(), np.diff(np.asarray(rc.indptr)))


def test_pattern_matrix():
    rmesh, pmesh = meshes((4, 2))
    rc = path_csr(40)
    ps = Sharded2DCSR.from_csr(from_reference(rc, CPU), pmesh)
    assert ps.vals is None
    assert_same_tiles(ps, ref_sharded2d.Sharded2DCSR.from_csr(rc, rmesh))
    want = np.full(40, 2.0, np.float32)
    want[0] = want[-1] = 1.0
    np.testing.assert_array_equal(sharded2d.spmv(ps, torch.ones(40), pmesh).numpy(), want)


def test_layout_and_context():
    rmesh, pmesh = meshes((2, 4))
    rc = random_csr(3, 50)
    ps = Sharded2DCSR.from_csr(from_reference(rc, CPU), pmesh)
    assert ps.context.is_equivalent(MeshContext(pmesh, "x"))
    assert ps.stacked("indptr").shape == (2, 4, ps.rows_per_tile + 1) and len(ps._tensors()) == 4 * 8
    tile = ps.tile_csr(1, 2)
    assert tile.shape == (ps.rows_per_tile, -(-50 // 4)) and tile.nnz == ps.nnz_counts[1][2]
    with pytest.raises(ValueError):
        sharded2d.degrees(ps, make_mesh_2d((4, 2), devices=["cpu"] * 8))


def test_interop_carries_the_tiles():
    rmesh, pmesh = meshes((4, 2))
    rs = ref_sharded2d.Sharded2DCSR.from_csr(random_csr(4, 64), rmesh)
    carried = from_reference(rs, pmesh)
    assert isinstance(carried, Sharded2DCSR) and carried.indptr[0][0].dtype == torch.int64
    assert carried.nnz_local[3][1].shape == ()
    assert_same_tiles(carried, rs)
    with pytest.raises(TypeMismatchError):
        from_reference(rs, make_mesh_2d((2, 2), devices=["cpu"] * 4))
