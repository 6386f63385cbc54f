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


# -- slice 8: spmv_csr methods, the donating pipeline, ReorderBase, config ----------


def ref_device_csr(row, col, vals, n):
    return ref.COO(jnp.asarray(row), jnp.asarray(col), jnp.asarray(vals), (n, n)).convert(ref.CSR)


def row_bounds(csr, x):
    """Per-row ``4·deg·eps·(|A||x|)_i`` and the cumsum's running-sum term
    ``8·eps·sqrt(nnz)·max|run|`` (float64)."""
    eps = np.finfo(np.float32).eps
    ip, ix, v = (to_numpy(csr)[k].astype(np.float64) for k in ("indptr", "indices", "vals"))
    prod = v * x.astype(np.float64)[ix.astype(np.int64)]
    absdot = np.add.reduceat(np.r_[np.abs(prod), 0.0], ip[:-1].astype(np.int64))
    absdot[np.diff(ip) == 0] = 0.0
    exact = np.add.reduceat(np.r_[prod, 0.0], ip[:-1].astype(np.int64))
    exact[np.diff(ip) == 0] = 0.0
    run = np.abs(np.cumsum(prod)).max(initial=0.0)
    return exact, 4 * np.diff(ip) * eps * absdot, 8 * eps * np.sqrt(len(ix)) * run


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_spmv_csr_methods_match_reference(name):
    from sparsebase_tpu.models.pipelines import spmv_csr as ref_spmv_csr

    row, col, vals, x = GRAPHS[name]()
    n = x.size
    csr = port_coo(row, col, vals, n).convert(CSR)
    rcsr = ref_device_csr(row, col, vals, n)
    xt = torch.from_numpy(x)
    exact, per_row, running = row_bounds(csr, x)
    seg = sbt.spmv_csr(csr, xt, method="segment")
    np.testing.assert_array_equal(seg.numpy(), np.asarray(ref_spmv_csr(rcsr, jnp.asarray(x), method="segment")))
    assert torch.equal(sbt.spmv_csr(csr, xt), seg)  # auto: exact per-row sums
    assert np.all(np.abs(seg.numpy() - exact) <= per_row)
    cum = sbt.spmv_csr(csr, xt, method="cumsum").numpy()
    ref_cum = np.asarray(ref_spmv_csr(rcsr, jnp.asarray(x), method="cumsum"))
    assert np.all(np.abs(cum - exact) <= per_row + running)
    assert np.all(np.abs(cum - ref_cum) <= 2 * (per_row + running))
    with pytest.raises(ValueError):
        sbt.spmv_csr(csr, xt, method="nope")


@pytest.mark.parametrize("method", ["auto", "segment", "cumsum"])
def test_spmv_on_complex_raises(method):
    from sparsebase_tpu_torch.utils.exceptions import TypeMismatchError

    csr = CSR(torch.tensor([0, 1, 2]), torch.tensor([0, 1], dtype=torch.int32),
              torch.tensor([1 + 2j, 3j], dtype=torch.complex64), (2, 2))
    with pytest.raises(TypeMismatchError):
        sbt.spmv_csr(csr, torch.ones(2), method=method)
    real = CSR(csr.indptr, csr.indices, csr.vals.real.contiguous(), csr.shape)
    with pytest.raises(TypeMismatchError):
        sbt.spmv_csr(real, torch.ones(2, dtype=torch.complex64), method=method)
    with pytest.raises(TypeMismatchError):
        sbt.spmv(csr, torch.ones(2))


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("shared", [False, True], ids=["own-storage", "row-col-one-storage"])
def test_preprocess_pipeline_donating_equals_plain(name, shared):
    import gc
    import weakref

    row, col, vals, x = GRAPHS[name]()
    n = x.size
    want_csr, want_y = sbt.preprocess_pipeline(port_coo(row, col, vals, n), torch.from_numpy(x))
    coo = port_coo(row, col, vals, n)
    if shared:  # row and col as two views of one buffer: the buffer must outlive the last reader of col
        both = torch.stack([coo.row, coo.col])
        coo = COO(both[0], both[1], coo.vals, coo.shape)
        del both
    tensors = [weakref.ref(t) for t in (coo.row, coo.col, coo.vals)]
    xt = torch.from_numpy(x.copy())
    got_csr, got_y = sbt.preprocess_pipeline_donating(coo, xt)
    for key in ("indptr", "indices", "vals"):
        assert torch.equal(getattr(got_csr, key), getattr(want_csr, key)), key
    assert torch.equal(got_y, want_y)
    assert torch.equal(xt, torch.from_numpy(x))  # x is not consumed
    gc.collect()
    assert all(t() is None for t in tensors)  # the COO held the last references
    with pytest.raises(RuntimeError, match="consumed"):
        coo.row.shape  # a consumed COO fails loudly
    with pytest.raises(RuntimeError, match="consumed"):
        sbt.preprocess_pipeline(coo, xt)


def test_preprocess_pipeline_donating_releases_row_after_indptr(monkeypatch):
    """``coo.row`` goes right after K3 has built ``indptr``, before the
    degree rank and the relocation run; ``coo.col`` stays until then."""
    import gc
    import weakref

    import sparsebase_tpu_torch.models.pipelines as pipes

    row, col, vals, x = GRAPHS["sparse"]()
    coo = port_coo(row, col, vals, x.size)
    row_ref, col_ref = weakref.ref(coo.row), weakref.ref(coo.col)
    seen = {}
    real = pipes.ranks_from_sort_keys

    def spy(*a, **k):
        gc.collect()
        seen["row"], seen["col"] = row_ref() is None, col_ref() is None
        return real(*a, **k)

    monkeypatch.setattr(pipes, "ranks_from_sort_keys", spy)
    sbt.preprocess_pipeline_donating(coo, torch.from_numpy(x))
    assert seen == {"row": True, "col": False}


def test_reorder_base_matches_direct_calls_and_reference():
    from sparsebase_tpu.bases import ReorderBase as RefReorderBase

    from sparsebase_tpu_torch import ReorderBase
    from sparsebase_tpu_torch.ops.permute import permute_1d
    from sparsebase_tpu_torch.ops.reorder import RCMReorder

    row, col, vals, x = GRAPHS["dups-empty-dense"]()
    n = x.size
    csr = port_coo(row, col, vals, n).convert(CSR)
    ref_csr = ref.COO.new(row, col, vals, (n, n)).convert(ref.CSR)
    for name, direct, params in [("degree", DegreeReorder(), None), ("DEGREE", DegreeReorder(False), False),
                                 ("degree", DegreeReorder(False), {"ascending": False}),
                                 ("rcm", RCMReorder(), None)]:
        got = ReorderBase.reorder(name, csr, params)
        assert torch.equal(got, direct.get_reorder(csr))
        np.testing.assert_array_equal(got.numpy(), np.asarray(RefReorderBase.reorder(name.lower(), ref_csr, params)))
        cached, again = ReorderBase.reorder_cached(name, csr, params)
        assert torch.equal(again, got) and cached == [None]
    assert torch.equal(ReorderBase.reorder(DegreeReorder, csr), DegreeReorder().get_reorder(csr))
    order = ReorderBase.reorder("degree", csr)
    co = torch.from_numpy(np.random.default_rng(9).permutation(n).astype(np.int32))
    for got, want in [(ReorderBase.permute2d(order, csr), permute_2d(csr, order, order)),
                      (ReorderBase.permute2d_cached(order, csr)[1], permute_2d(csr, order, order)),
                      (ReorderBase.permute2d_rowwise(order, csr), permute_2d(csr, order, None)),
                      (ReorderBase.permute2d_colwise(co, csr), permute_2d(csr, None, co)),
                      (ReorderBase.permute2d_row_columnwise(order, co, csr), permute_2d(csr, order, co))]:
        assert all(torch.equal(getattr(got, k), getattr(want, k)) for k in ("indptr", "indices", "vals"))
    arr = sbt.DenseArray(torch.from_numpy(x))
    assert torch.equal(ReorderBase.permute1d(order, arr).vals, permute_1d(arr, order).vals)
    assert torch.equal(ReorderBase.permute1d_cached(order, arr)[1].vals, permute_1d(arr, order).vals)
    assert torch.equal(ReorderBase.inverse_permutation(order), inverse_permutation(order))
    # every reorderer is ported: "gray" runs and equals the JAX package's
    np.testing.assert_array_equal(ReorderBase.reorder("gray", csr).numpy(),
                                  np.asarray(RefReorderBase.reorder("gray", ref_csr)))
    with pytest.raises(KeyError):
        ReorderBase.reorder("no-such-reorderer", csr)


def test_config_round_trips():
    import dataclasses

    from sparsebase_tpu.config import Config as RefConfig

    from sparsebase_tpu_torch import Config, get_config, set_config
    from sparsebase_tpu_torch.utils.logger import Logger, LogLevel

    saved, level = get_config(), Logger.get_level()
    try:
        ours = {f.name for f in dataclasses.fields(Config)}
        theirs = {f.name for f in dataclasses.fields(RefConfig)}
        assert ours == {"use_fastio", "use_graphkit", "log_level"} and ours <= theirs
        for name in ("use_fastio", "use_graphkit"):
            assert getattr(set_config(**{name: False}), name) is False and getattr(get_config(), name) is False
            set_config(**{name: True})
            assert getattr(get_config(), name) is True
        set_config(log_level="info")
        assert Logger.get_level() == LogLevel.LOG_LVL_INFO
        # the JAX package's settings that nothing reads, its TPU guards, and a made-up name
        for name in sorted(theirs - ours) + ["no_such_field"]:
            with pytest.raises(TypeError):
                set_config(**{name: 1})
    finally:
        set_config(**{f: getattr(saved, f) for f in saved.__dataclass_fields__})
        Logger.set_level(level)


@pytest.mark.parametrize("n", [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 40])
def test_index_dtype_for_matches_reference(n):
    from sparsebase_tpu.utils.typing import index_dtype_for as ref_index_dtype_for

    from sparsebase_tpu_torch.utils.typing import index_dtype_for

    assert str(index_dtype_for(n)).replace("torch.", "") == np.dtype(ref_index_dtype_for(n)).name


@pytest.mark.parametrize("stable_payload", [True, False])
def test_coo_new_takes_stable_payload(stable_payload):
    rng = np.random.default_rng(12)
    row, col = rng.integers(0, 30, 500).astype(np.int32), rng.integers(0, 30, 500).astype(np.int32)
    vals = np.arange(500, dtype=np.float32)  # payload order among duplicates shows in the values
    want = ref.COO.new(row, col, vals, shape=(30, 30), stable_payload=stable_payload)
    got = COO.new(torch.from_numpy(row), torch.from_numpy(col), torch.from_numpy(vals), (30, 30),
                  stable_payload=stable_payload)
    np.testing.assert_array_equal(got.row.numpy(), np.asarray(want.row))
    np.testing.assert_array_equal(got.col.numpy(), np.asarray(want.col))
    stable = np.lexsort((col, row))
    np.testing.assert_array_equal(got.vals.numpy(), vals[stable])  # stable either way
    unsorted = COO(torch.from_numpy(row), torch.from_numpy(col), torch.from_numpy(vals), (30, 30))
    assert torch.equal(unsorted.sort_rowmajor(stable_payload=stable_payload).vals, got.vals)
