"""Port parity for RCM (``ops/reorder/rcm.py``) and ``rcm_pipeline``, on the CPU.

The host route must equal the reference C++ library's own orders
(``tests/golden/*/rcm_order.txt``) and the JAX ``_rcm_host``; the device
route, run as the same torch ops on CPU tensors, must equal the JAX
``_rcm_device`` (a different root choice). Both exactly. Inputs are numpy
arrays from a seed; every JAX call runs on the CPU.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import sparsebase_tpu as ref  # noqa: E402
from sparsebase_tpu.formats.dia import DIA as RefDIA  # noqa: E402
from sparsebase_tpu.models.pipelines import rcm_pipeline as ref_rcm_pipeline  # noqa: E402
from sparsebase_tpu.ops.reorder import RCMReorder as RefRCMReorder  # noqa: E402
from sparsebase_tpu.ops.reorder import rcm as ref_rcm  # noqa: E402

import sparsebase_tpu_torch as sbt  # noqa: E402
from sparsebase_tpu_torch import COO, CSR, DIA  # noqa: E402
from sparsebase_tpu_torch.interop import to_numpy  # noqa: E402
from sparsebase_tpu_torch.ops.kernels import relocate_csr_plain  # noqa: E402
from sparsebase_tpu_torch.ops.permute import permute_2d  # noqa: E402
from sparsebase_tpu_torch.ops.reorder import RCMReorder  # noqa: E402
from sparsebase_tpu_torch.ops.reorder.rcm import _rcm_device, _rcm_host, _symmetrized_square  # noqa: E402

GOLDEN = Path(__file__).resolve().parent / "golden"


def sorted_pattern(row, col, n, m=None):
    """``(indptr int64, indices int32)`` of the row-major-sorted entries."""
    order = np.lexsort((col, row))
    row, col = np.asarray(row)[order], np.asarray(col)[order].astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(row, minlength=n))]).astype(np.int64)
    return indptr, col


def scrambled(row, col, n, seed):
    perm = np.random.default_rng(seed).permutation(n)
    return perm[row], perm[col]


def symmetric(row, col):
    return np.r_[row, col], np.r_[col, row]


def tridiagonal(n):
    i = np.arange(n)
    row = np.r_[i, i[1:], i[:-1]]
    col = np.r_[i, i[1:] - 1, i[:-1] + 1]
    return row, col


def random_graph(seed, n=48, m=240):
    """The random graph of the JAX package's ``rcm_pipeline`` test: directed,
    duplicates kept."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, m), rng.integers(0, n, m)


def components(seed):
    """Three random symmetric blocks and six isolated vertices, scrambled."""
    rng = np.random.default_rng(seed)
    rows, cols, base = [], [], 0
    for size, edges in ((30, 50), (12, 15), (20, 25)):
        r, c = symmetric(rng.integers(0, size, edges), rng.integers(0, size, edges))
        rows.append(r + base)
        cols.append(c + base)
        base += size
    return scrambled(np.concatenate(rows), np.concatenate(cols), base + 6, seed)


def isolated_zero(seed):
    """Vertex 0 and a few others isolated; the rest a random symmetric graph."""
    rng = np.random.default_rng(seed)
    r, c = symmetric(rng.integers(5, 60, 90), rng.integers(5, 60, 90))
    keep = (r != 9) & (c != 9)
    return r[keep], c[keep]


# name -> (row, col, n): symmetric graphs
GRAPHS = {
    "scrambled-tridiagonal-64": lambda: (*scrambled(*tridiagonal(64), 64, 1), 64),
    "random-48": lambda: (*symmetric(*random_graph(0)), 48),
    "path-50": lambda: (np.r_[np.arange(49), np.arange(1, 50)], np.r_[np.arange(1, 50), np.arange(49)], 50),
    "scrambled-path-50": lambda: (*scrambled(np.r_[np.arange(49), np.arange(1, 50)],
                                             np.r_[np.arange(1, 50), np.arange(49)], 50, 2), 50),
    "vertex-0-isolated": lambda: (*isolated_zero(3), 60),
    "components": lambda: (*components(4), 68),
}


def port_csr(indptr, indices, shape):
    return CSR(torch.from_numpy(indptr), torch.from_numpy(indices), None, shape)


def ref_csr(indptr, indices, shape, device=False):
    if device:
        return ref.CSR(jnp.asarray(indptr), jnp.asarray(indices), None, shape)
    return ref.CSR(indptr, indices, None, shape)


def golden_csr(name):
    indptr = np.loadtxt(GOLDEN / name / "csr_indptr.txt", dtype=np.int64)
    indices = np.loadtxt(GOLDEN / name / "csr_indices.txt", dtype=np.int32)
    n = indptr.size - 1
    return indptr, indices, (n, n)


@pytest.mark.parametrize("name", ["ash958_sym", "g960"])
def test_host_route_equals_reference_library(name):
    indptr, indices, shape = golden_csr(name)
    want = np.loadtxt(GOLDEN / name / "rcm_order.txt", dtype=np.int64)
    order = RCMReorder().get_reorder(port_csr(indptr, indices, shape))
    assert order.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(), want)
    np.testing.assert_array_equal(_rcm_host(_symmetrized_square(port_csr(indptr, indices, shape))).numpy(), want)


@pytest.mark.parametrize("name", ["ash958_sym", "g960", "random-48", "wide", "tall"])
def test_symmetrized_square_matches_reference(name):
    if name in ("ash958_sym", "g960"):
        indptr, indices, shape = golden_csr(name)
    elif name == "random-48":
        indptr, indices = sorted_pattern(*random_graph(0), 48)
        shape = (48, 48)
    else:
        rng = np.random.default_rng(5)
        n, m = (30, 70) if name == "wide" else (70, 30)
        indptr, indices = sorted_pattern(rng.integers(0, n, 200), rng.integers(0, m, 200), n)
        shape = (n, m)
    got = _symmetrized_square(port_csr(indptr, indices, shape))
    for device in (False, True):
        want = ref_rcm._symmetrized_square(ref_csr(indptr, indices, shape, device))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.indptr.numpy(), np.asarray(want.indptr))
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
        assert got.vals is None and want.vals is None


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_host_route_matches_reference(name):
    row, col, n = GRAPHS[name]()
    indptr, indices = sorted_pattern(row, col, n)
    sym = _symmetrized_square(port_csr(indptr, indices, (n, n)))
    want = ref_rcm._rcm_host(ref_rcm._symmetrized_square(ref_csr(indptr, indices, (n, n))))
    got = _rcm_host(sym)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sorted(got.tolist()) == list(range(n))


@pytest.mark.parametrize("symmetrize", [True, False], ids=["symmetrized", "out-edges"])
@pytest.mark.parametrize("name", sorted(GRAPHS) + ["random-48-directed"])
def test_device_route_matches_reference(name, symmetrize):
    if name == "random-48-directed":
        row, col, n = *random_graph(0), 48
    else:
        row, col, n = GRAPHS[name]()
    indptr, indices = sorted_pattern(row, col, n)
    csr = port_csr(indptr, indices, (n, n))
    want_csr = ref_csr(indptr, indices, (n, n), device=True)
    if symmetrize:
        csr, want_csr = _symmetrized_square(csr), ref_rcm._symmetrized_square(want_csr)
    stats = {}
    got = _rcm_device(csr, stats=stats)
    want = np.asarray(ref_rcm._rcm_device(want_csr))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert sorted(got.tolist()) == list(range(n))
    assert stats["level_steps"] >= 1


@pytest.mark.parametrize("name", ["components", "scrambled-tridiagonal-64"])
def test_device_route_rank_by_two_sorts(name, monkeypatch):
    """Where (run, degree, id) do not fit one 63-bit key, two stable sorts
    rank the level: the same order."""
    from sparsebase_tpu_torch.ops.reorder import rcm

    row, col, n = GRAPHS[name]()
    indptr, indices = sorted_pattern(row, col, n)
    sym = _symmetrized_square(port_csr(indptr, indices, (n, n)))
    packed = _rcm_device(sym)
    monkeypatch.setattr(rcm, "_KEY_BITS", 8)
    np.testing.assert_array_equal(_rcm_device(sym).numpy(), packed.numpy())


@pytest.mark.parametrize("name", ["components", "scrambled-tridiagonal-64"])
def test_device_route_sizes_keys_from_the_largest_degree(name, monkeypatch):
    """The degree field of the packed key is as wide as the largest degree,
    not as nnz: at exactly that many bits the key is packed, and the order
    is the JAX one."""
    from sparsebase_tpu_torch.ops.reorder import rcm

    row, col, n = GRAPHS[name]()
    indptr, indices = sorted_pattern(row, col, n)
    sym = _symmetrized_square(port_csr(indptr, indices, (n, n)))
    g = rcm._Graph(sym)
    top_bits = int(g.degrees.max()).bit_length()
    assert top_bits < sym.nnz.bit_length()
    monkeypatch.setattr(rcm, "_KEY_BITS", 2 * g.id_bits + top_bits)
    assert g.read(torch.tensor(5), torch.tensor(7)) == [5, 7]
    assert g.deg_bits == top_bits and g.deg_id is not None
    want = ref_rcm._rcm_device(ref_rcm._symmetrized_square(ref_csr(indptr, indices, (n, n), True)))
    np.testing.assert_array_equal(_rcm_device(sym).numpy(), np.asarray(want))


def test_device_route_on_an_empty_graph():
    empty = CSR(torch.zeros((1,), dtype=torch.int64), torch.zeros((0,), dtype=torch.int32), None, (0, 0))
    got = _rcm_device(empty)
    assert got.dtype == torch.int32 and got.shape == (0,)


@pytest.mark.parametrize("peripheral_iters", [0, 1, 3])
def test_device_route_root_search_depth(peripheral_iters):
    row, col, n = GRAPHS["components"]()
    indptr, indices = sorted_pattern(row, col, n)
    sym = _symmetrized_square(port_csr(indptr, indices, (n, n)))
    want = ref_rcm._rcm_device(ref_rcm._symmetrized_square(ref_csr(indptr, indices, (n, n), True)),
                               peripheral_iters=peripheral_iters)
    np.testing.assert_array_equal(_rcm_device(sym, peripheral_iters=peripheral_iters).numpy(), np.asarray(want))


def test_rcm_reorder_on_coo_converts():
    row, col, n = GRAPHS["components"]()
    vals = np.random.default_rng(7).standard_normal(row.size).astype(np.float32)
    coo = COO.new(torch.from_numpy(row.astype(np.int32)), torch.from_numpy(col.astype(np.int32)),
                  torch.from_numpy(vals), (n, n))
    want = RefRCMReorder().get_reorder(ref.COO.new(row.astype(np.int32), col.astype(np.int32), vals, (n, n)))
    converted, got = RCMReorder().get_reorder_cached(coo)
    assert isinstance(converted[0], CSR)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(30, 70), (70, 30)], ids=["wide", "tall"])
def test_rcm_reorder_folds_rectangular(shape):
    rng = np.random.default_rng(8)
    n, m = shape
    indptr, indices = sorted_pattern(rng.integers(0, n, 150), rng.integers(0, m, 150), n)
    got = RCMReorder().get_reorder(port_csr(indptr, indices, shape))
    want = RefRCMReorder().get_reorder(ref_csr(indptr, indices, shape))
    assert got.shape == (n,) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sorted(got.tolist()) == list(range(n))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rcm_pipeline_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = 48
    row, col = random_graph(seed)
    order = np.lexsort((col, row))
    row, col = row[order].astype(np.int32), col[order].astype(np.int32)
    vals = rng.standard_normal(row.size).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    want_csr, want_y = jax.jit(ref_rcm_pipeline)(
        ref.COO(jnp.asarray(row), jnp.asarray(col), jnp.asarray(vals), (n, n)), jnp.asarray(x))
    coo = COO.new(torch.from_numpy(row), torch.from_numpy(col), torch.from_numpy(vals), (n, n))
    got_csr, got_y = sbt.rcm_pipeline(coo, torch.from_numpy(x))
    got = to_numpy(got_csr)
    np.testing.assert_array_equal(got["indptr"], np.asarray(want_csr.indptr))
    np.testing.assert_array_equal(got["indices"], np.asarray(want_csr.indices))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-4, atol=1e-4)
    # ro: the device route on the out-edges, as the JAX pipeline takes it
    indptr, _ = sorted_pattern(row, col, n)
    ro = _rcm_device(CSR(torch.from_numpy(indptr), coo.col, coo.vals, (n, n)))
    want_ro = ref_rcm._rcm_device(ref.CSR(jnp.asarray(indptr), jnp.asarray(col), jnp.asarray(vals), (n, n)))
    np.testing.assert_array_equal(ro.numpy(), np.asarray(want_ro))
    plain = relocate_csr_plain(coo.convert(CSR), ro, ro)
    for key in ("indptr", "indices", "vals"):
        np.testing.assert_array_equal(got[key], to_numpy(plain)[key], err_msg=key)


def test_rcm_pipeline_rejects_rectangular():
    coo = COO.new(torch.tensor([0, 1], dtype=torch.int32), torch.tensor([0, 2], dtype=torch.int32),
                  torch.ones(2), (2, 3))
    with pytest.raises(ValueError):
        sbt.rcm_pipeline(coo, torch.ones(3))


def test_scrambled_tridiagonal_rcm_dia_spmv():
    """The reorder → band → DIA SpMV flow of the JAX package's DIA tests:
    RCM recovers a narrow band from a scrambled tridiagonal matrix."""
    n = 64
    row, col = tridiagonal(n)
    vals = (row + col + 1).astype(np.float32)
    perm = np.random.default_rng(1).permutation(n).astype(np.int32)
    coo = COO.new(torch.from_numpy(row.astype(np.int32)), torch.from_numpy(col.astype(np.int32)),
                  torch.from_numpy(vals), (n, n))
    scrambled_csr = permute_2d(coo.convert(CSR), torch.from_numpy(perm), torch.from_numpy(perm))
    order = RCMReorder().get_reorder(scrambled_csr)
    banded = permute_2d(scrambled_csr, order, order)
    dia = banded.convert(DIA)
    assert dia.bandwidth <= 4
    x = torch.ones(n)
    y = sbt.spmv(dia, x)
    np.testing.assert_allclose(y.numpy(), banded.to_dense().double().numpy() @ x.double().numpy(),
                               rtol=1e-5, atol=1e-4)
    ref_scrambled = ref.COO.new(row.astype(np.int32), col.astype(np.int32), vals, (n, n)).convert(ref.CSR)
    from sparsebase_tpu.ops.permute import permute_2d as ref_permute_2d

    ref_scrambled = ref_permute_2d(ref_scrambled, perm, perm)
    want_order = RefRCMReorder().get_reorder(ref_scrambled)
    np.testing.assert_array_equal(order.numpy(), np.asarray(want_order))
    want_dia = ref_permute_2d(ref_scrambled, want_order, want_order).convert(RefDIA)
    assert dia.offsets.tolist() == np.asarray(want_dia.offsets).tolist()
