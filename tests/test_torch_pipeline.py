"""Port parity for the slice as a whole, on the CPU.

Path A: ``preprocess_pipeline`` (COO → CSR → degree reorder → symmetric
permutation → SpMV) against ``jax.jit(preprocess_pipeline)`` of the JAX
package. Path B: banded COO → CSR → DIA → ``spmv(dia, x)`` against the
JAX ``spmv`` and the port's ``spmv(csr, x)``. Path C: the op-level chain
``convert(CSR)`` → ``DegreeReorder(ascending=False)`` → ``permute_2d`` →
``spmv`` against the same JAX ops. Also the reorder and permute ops on
their own.

Tolerances: the permuted structure (``indptr``, ``indices``) and ``ro``
must match exactly. ``vals`` are compared after a canonical (row, col,
val) sort, since the order of duplicate coordinates' payloads is
unspecified on the reference's device path. ``y`` is held at rtol/atol
1e-4: the reference sums with a global f32 cumsum whose error grows like
eps·sqrt(nnz) (sparsebase_tpu/models/pipelines.py:47-48).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import sparsebase_tpu as ref  # noqa: E402
from sparsebase_tpu.formats.dia import DIA as RefDIA  # noqa: E402
from sparsebase_tpu.models.pipelines import preprocess_pipeline as ref_pipeline  # noqa: E402
from sparsebase_tpu.models.pipelines import spmv as ref_spmv  # noqa: E402
from sparsebase_tpu.ops.permute import inverse_permutation as ref_inverse  # noqa: E402
from sparsebase_tpu.ops.permute import permute_2d as ref_permute_2d  # noqa: E402
from sparsebase_tpu.ops.reorder import DegreeReorder as RefDegreeReorder  # noqa: E402

import sparsebase_tpu_torch as sbt  # noqa: E402
from sparsebase_tpu_torch import COO, CSR, DIA  # noqa: E402
from sparsebase_tpu_torch.interop import to_numpy  # noqa: E402
from sparsebase_tpu_torch.ops.permute import inverse_permutation, permute_2d  # noqa: E402
from sparsebase_tpu_torch.ops.reorder import DegreeReorder  # noqa: E402

CPU = torch.device("cpu")


def graph(seed, n, nnz, empty_tail=0, dense_row=None):
    """Row-major-sorted triplets with duplicate coordinates, empty rows
    (every 9th row, plus the last ``empty_tail`` rows) and optionally one
    dense row; columns 20% from a clump, as in the benchmark graph."""
    rng = np.random.default_rng(seed)
    live = np.array([r for r in range(n - empty_tail) if r % 9 != 4])
    row = rng.choice(live, nnz)
    col = np.where(rng.random(nnz) < 0.2, rng.integers(0, max(n // 100, 1), nnz), rng.integers(0, n, nnz))
    row[:20], col[:20] = row[0], col[0]  # 20 copies of one coordinate
    if dense_row is not None:
        row = np.r_[row, np.full(n, dense_row)]
        col = np.r_[col, np.arange(n)]
    order = np.lexsort((col, row))
    row, col = row[order].astype(np.int32), col[order].astype(np.int32)
    vals = rng.standard_normal(row.size).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    return row, col, vals, x


GRAPHS = {
    "dups-empty-dense": lambda: graph(0, 400, 4000, dense_row=17),
    "empty-tail": lambda: graph(1, 300, 2500, empty_tail=40),
    "sparse": lambda: graph(2, 1500, 3000, dense_row=1499),
}


def canonical(csr_np):
    """(row, col, val) triples sorted lexicographically."""
    indptr = np.asarray(csr_np["indptr"]).astype(np.int64)
    row = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    col = np.asarray(csr_np["indices"])
    val = np.asarray(csr_np["vals"])
    order = np.lexsort((val, col, row))
    return row[order], col[order], val[order]


def port_coo(row, col, vals, n):
    return COO.new(torch.from_numpy(row), torch.from_numpy(col), torch.from_numpy(vals), (n, n))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_preprocess_pipeline_matches_reference(name):
    row, col, vals, x = GRAPHS[name]()
    n = x.size
    want_csr, want_y = jax.jit(ref_pipeline)(
        ref.COO(jnp.asarray(row), jnp.asarray(col), jnp.asarray(vals), (n, n)), jnp.asarray(x)
    )
    coo = port_coo(row, col, vals, n)
    got_csr, got_y = sbt.preprocess_pipeline(coo, torch.from_numpy(x))
    got, want = to_numpy(got_csr), {k: np.asarray(getattr(want_csr, k)) for k in ("indptr", "indices", "vals")}
    np.testing.assert_array_equal(got["indptr"], want["indptr"])
    np.testing.assert_array_equal(got["indices"], want["indices"])
    for a, b in zip(canonical(got), canonical(want)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-4, atol=1e-4)

    # ro: the port's and the reference's DegreeReorder agree exactly, and the
    # pipeline's permutation is permute_2d(csr, ro, ro)
    csr = coo.convert(CSR)
    ro = DegreeReorder().get_reorder(csr)
    assert ro.dtype == torch.int32
    want_ro = RefDegreeReorder().get_reorder(ref.COO.new(row, col, vals, (n, n)).convert(ref.CSR))
    np.testing.assert_array_equal(ro.numpy(), np.asarray(want_ro))
    assert sorted(ro.tolist()) == list(range(n))
    again = permute_2d(csr, ro, ro)
    for key in ("indptr", "indices", "vals"):
        np.testing.assert_array_equal(to_numpy(again)[key], got[key], err_msg=key)
    # y = P·(A@x): the permuted matrix applied to the permuted vector
    x_new = torch.empty(n)
    x_new[ro] = torch.from_numpy(x)
    np.testing.assert_allclose(sbt.spmv(got_csr, x_new).numpy(), got_y.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_path_c_matches_reference(name):
    """Path C, the op-level entry point: ``convert(CSR)`` →
    ``DegreeReorder(ascending=False)`` → ``permute_2d`` with a random column
    order and with rows only → ``spmv``, against the same chain of JAX ops
    on device arrays (JAX on the CPU)."""
    row, col, vals, x = GRAPHS[name]()
    n = x.size
    co = np.random.default_rng(6).permutation(n).astype(np.int32)
    x_perm = np.empty_like(x)
    x_perm[co] = x  # the vector in the permuted column space

    ref_csr = ref.COO(jnp.asarray(row), jnp.asarray(col), jnp.asarray(vals), (n, n)).convert(ref.CSR)
    want_ro = np.asarray(RefDegreeReorder(ascending=False).get_reorder(ref_csr))
    want_both = ref_permute_2d(ref_csr, jnp.asarray(want_ro), jnp.asarray(co))
    want_rows = ref_permute_2d(ref_csr, jnp.asarray(want_ro), None)
    want_y = np.asarray(ref_spmv(want_both, jnp.asarray(x_perm)))

    csr = port_coo(row, col, vals, n).convert(CSR)
    ro = DegreeReorder(ascending=False).get_reorder(csr)
    np.testing.assert_array_equal(ro.numpy(), want_ro)
    both = permute_2d(csr, ro, torch.from_numpy(co))
    rows = permute_2d(csr, ro, None)
    y = sbt.spmv(both, torch.from_numpy(x_perm))
    for got_csr, want_csr in ((both, want_both), (rows, want_rows)):
        got = to_numpy(got_csr)
        want = {k: np.asarray(getattr(want_csr, k)) for k in ("indptr", "indices", "vals")}
        np.testing.assert_array_equal(got["indptr"], want["indptr"])
        np.testing.assert_array_equal(got["indices"], want["indices"])
        for a, b in zip(canonical(got), canonical(want)):
            np.testing.assert_array_equal(a, b)
    assert bool((rows.degrees()[1:] <= rows.degrees()[:-1]).all())  # descending degrees
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-4, atol=1e-4)
    # y = P·(A@x): row ro[i] of the permuted product is row i of A@x
    y_src = sbt.spmv(csr, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y.numpy()[ro.numpy()], y_src, rtol=1e-5, atol=1e-5)


def test_preprocess_pipeline_rejects_rectangular():
    coo = COO.new(torch.tensor([0, 1], dtype=torch.int32), torch.tensor([0, 2], dtype=torch.int32),
                  torch.ones(2), (2, 3))
    with pytest.raises(ValueError):
        sbt.preprocess_pipeline(coo, torch.ones(3))


@pytest.mark.parametrize("fmt", ["CSR", "COO"])
@pytest.mark.parametrize("which", ["rows", "cols", "both"])
def test_permute_2d_matches_reference(fmt, which):
    row, col, vals, _ = GRAPHS["dups-empty-dense"]()
    n = 400
    perm = np.random.default_rng(3).permutation(n).astype(np.int32)
    ro = perm if which in ("rows", "both") else None
    co = perm[::-1].copy() if which in ("cols", "both") else None
    want_fmt = ref.COO.new(row, col, vals, (n, n))
    got_fmt = port_coo(row, col, vals, n)
    if fmt == "CSR":
        want_fmt, got_fmt = want_fmt.convert(ref.CSR), got_fmt.convert(CSR)
    want = ref_permute_2d(want_fmt, ro, co)
    got = permute_2d(got_fmt, None if ro is None else torch.from_numpy(ro),
                     None if co is None else torch.from_numpy(co))
    assert type(got).__name__ == fmt
    want_np = {k: np.asarray(v) for k, v in vars(want).items() if k != "_shape"}
    for key, value in to_numpy(got).items():
        if key != "shape":
            np.testing.assert_array_equal(value, want_np[key], err_msg=key)


def test_inverse_permutation_matches_reference():
    order = np.random.default_rng(4).permutation(97).astype(np.int32)
    got = inverse_permutation(torch.from_numpy(order))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_inverse(order)))


@pytest.mark.parametrize("shape,offsets", [((2000, 2000), tuple(range(-16, 17))), ((500, 650), (-3, 0, 1, 140))],
                         ids=["33-diagonals", "rectangular"])
def test_path_b_banded_spmv(shape, offsets):
    n, m = shape
    rng = np.random.default_rng(5)
    i = np.arange(n)[:, None]
    j = i + np.asarray(offsets)[None, :]
    ok = (j >= 0) & (j < m)
    row = np.broadcast_to(i, j.shape)[ok].astype(np.int32)
    col = j[ok].astype(np.int32)
    vals = rng.standard_normal(row.size).astype(np.float32)
    x = rng.standard_normal(m).astype(np.float32)

    coo = COO.new(torch.from_numpy(row), torch.from_numpy(col), torch.from_numpy(vals), shape)
    csr = coo.convert(CSR)
    dia = csr.convert(DIA)
    assert dia.num_diagonals == len(offsets)
    y_dia = sbt.spmv(dia, torch.from_numpy(x))
    want_dia = ref.COO.new(row, col, vals, shape).convert(ref.CSR).convert(RefDIA)
    np.testing.assert_allclose(y_dia.numpy(), np.asarray(ref_spmv(want_dia, x)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y_dia.numpy(), sbt.spmv(csr, torch.from_numpy(x)).numpy(), rtol=1e-5, atol=1e-5)
    # a COO dispatches through the conversion graph to the CSR kernel
    np.testing.assert_allclose(sbt.spmv(coo, torch.from_numpy(x)).numpy(), y_dia.numpy(), rtol=1e-5, atol=1e-5)
