"""Port parity: formats, conversions, contexts, dispatch and interop of
``sparsebase_tpu_torch`` against the JAX reference package, on the CPU.

Inputs are numpy arrays from a seed; both packages get the same arrays and
the results must match exactly.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import sparsebase_tpu as ref  # noqa: E402
from sparsebase_tpu.convert import convert as ref_convert  # noqa: E402
from sparsebase_tpu.formats.dia import DIA as RefDIA  # noqa: E402
from sparsebase_tpu.formats.ell import ELL as RefELL  # noqa: E402

import sparsebase_tpu_torch as sbt  # noqa: E402
from sparsebase_tpu_torch import COO, CSC, CSR, DIA, ELL  # noqa: E402
from sparsebase_tpu_torch.context import DeviceContext, HostContext, context_for  # noqa: E402
from sparsebase_tpu_torch.convert import ConversionGraph, convert, convert_cached  # noqa: E402
from sparsebase_tpu_torch.interop import from_reference, to_numpy  # noqa: E402
from sparsebase_tpu_torch.utils.exceptions import (  # noqa: E402
    ConversionError,
    DirectExecutionNotAvailableError,
    FunctionNotFoundError,
    TypeMismatchError,
)
from sparsebase_tpu_torch.utils.typing import can_dtype_fit, convert_array_dtype  # noqa: E402

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parent.parent


def random_triplets(seed, n, m, nnz, pattern=False):
    """Unsorted triplets with duplicate coordinates."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n, nnz).astype(np.int32)
    col = rng.integers(0, m, nnz).astype(np.int32)
    row[-5:], col[-5:] = row[0], col[0]  # duplicates of one coordinate
    vals = None if pattern else rng.standard_normal(nnz).astype(np.float32)
    return row, col, vals


def banded_triplets(seed, n, m, offsets):
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for off in offsets:
        i = np.arange(n)
        ok = (i + off >= 0) & (i + off < m)
        rows.append(i[ok])
        cols.append(i[ok] + off)
    row = np.concatenate(rows).astype(np.int32)
    col = np.concatenate(cols).astype(np.int32)
    return row, col, rng.standard_normal(row.size).astype(np.float32)


def t(a):
    return None if a is None else torch.from_numpy(np.asarray(a).copy())


def assert_same(port_fmt, ref_fmt):
    """Every array field equal, exactly, with the same shape."""
    got = to_numpy(port_fmt)
    want = to_numpy(from_reference(ref_fmt, CPU))
    assert got["shape"] == want["shape"]
    for key in got:
        if key == "shape":
            continue
        if want[key] is None:
            assert got[key] is None, key
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


MATRICES = {
    "square": lambda p: random_triplets(0, 60, 60, 500, p),
    "wide": lambda p: random_triplets(1, 40, 90, 300, p),
    "tall": lambda p: random_triplets(2, 90, 30, 300, p),
}


@pytest.mark.parametrize("pattern", [False, True], ids=["valued", "pattern"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_coo_new_sorts_like_reference(name, pattern):
    row, col, vals = MATRICES[name](pattern)
    shape = (int(row.max()) + 1, int(col.max()) + 1)
    port = COO.new(t(row), t(col), t(vals), shape)
    want = ref.COO.new(row, col, vals, shape)
    assert port.is_sorted() and not COO(t(row), t(col), t(vals), shape).is_sorted()
    assert_same(port, want)
    assert port.nnz == want.nnz and port.shape == want.shape


def test_csr_new_repairs_row_order():
    rng = np.random.default_rng(3)
    indptr = np.array([0, 3, 3, 7, 8], np.int64)
    indices = np.array([5, 1, 3, 9, 0, 4, 2, 6], np.int32)
    vals = rng.standard_normal(8).astype(np.float32)
    port = CSR.new(t(indptr), t(indices), t(vals), (4, 10))
    want = ref.CSR.new(indptr, indices, vals, (4, 10))
    assert port.is_sorted()
    assert_same(port, want)
    np.testing.assert_array_equal(port.row_of_nnz().numpy(), want.row_of_nnz())


@pytest.mark.parametrize("pattern", [False, True], ids=["valued", "pattern"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_conversions_match_reference(name, pattern):
    row, col, vals = MATRICES[name](pattern)
    shape = (int(row.max()) + 1, int(col.max()) + 1)
    port = COO.new(t(row), t(col), t(vals), shape)
    want = ref.COO.new(row, col, vals, shape)
    port_csr, want_csr = port.convert(CSR), want.convert(ref.CSR)
    assert_same(port_csr, want_csr)
    assert port_csr.indptr.dtype == torch.int64 and port_csr.indices.dtype == torch.int32
    assert_same(port_csr.convert(COO), want_csr.convert(ref.COO))
    np.testing.assert_array_equal(port.to_dense().numpy(), want.to_dense())
    np.testing.assert_array_equal(port_csr.to_dense().numpy(), want_csr.to_dense())


@pytest.mark.parametrize(
    "shape,offsets",
    [((50, 50), (-1, 0, 1)), ((64, 64), (-9, -2, 0, 5, 30)), ((30, 70), (0, 3, 41)), ((70, 30), (-50, -1, 2))],
    ids=["tridiag", "wide-band", "wide-matrix", "tall-matrix"],
)
def test_dia_multihop_and_back(shape, offsets):
    row, col, vals = banded_triplets(4, *shape, offsets)
    port = COO.new(t(row), t(col), t(vals), shape)
    want = ref.COO.new(row, col, vals, shape)
    port_dia = convert(port, DIA)  # COO -> CSR -> DIA through the graph
    want_dia = ref_convert(want, RefDIA)
    assert_same(port_dia, want_dia)
    assert port_dia.offsets.tolist() == sorted(offsets)
    assert port_dia.bandwidth == want_dia.bandwidth and port_dia.nnz == want_dia.nnz
    np.testing.assert_array_equal(port_dia.to_dense().numpy(), want_dia.to_dense())
    assert_same(port_dia.convert(CSR), want_dia.convert(ref.CSR))
    steps = convert_cached(port, DIA)
    assert [type(s) for s in steps] == [CSR, DIA]


def test_conversion_graph_errors_and_chains():
    row, col, vals = MATRICES["square"](False)
    coo = COO.new(t(row), t(col), t(vals))
    assert sbt.can_convert(COO, DIA) and coo.can_convert(CSR)
    with pytest.raises(ConversionError):
        ConversionGraph().convert(coo, CSR)
    assert convert_cached(coo, COO) == [coo]
    assert coo.as_format(COO) is coo
    with pytest.raises(TypeMismatchError):
        coo.as_format(CSR)


@pytest.mark.parametrize(
    "values,to_dtype,fits",
    [
        (torch.tensor([0, 2**31 - 1], dtype=torch.int64), torch.int32, True),
        (torch.tensor([0, 2**31], dtype=torch.int64), torch.int32, False),
        (torch.tensor([-1.0, 7.0]), torch.int32, True),
        (torch.tensor([0.5]), torch.int32, False),
        (torch.tensor([2**24 + 1], dtype=torch.int64), torch.float32, False),
        (torch.tensor([1e39], dtype=torch.float64), torch.float32, False),
        (torch.tensor([1e30, float("inf")], dtype=torch.float64), torch.float32, True),
    ],
)
def test_checked_casts(values, to_dtype, fits):
    assert can_dtype_fit(to_dtype, values) is fits
    if fits:
        assert convert_array_dtype(values, to_dtype).dtype == to_dtype
    else:
        with pytest.raises(TypeMismatchError):
            convert_array_dtype(values, to_dtype)


def test_astype_and_narrowing_overflow():
    row, col, vals = MATRICES["square"](False)
    coo = COO.new(t(row), t(col), t(vals))
    wide = coo.astype(id_dtype=torch.int64, value_dtype=torch.float64)
    assert wide.row.dtype == torch.int64 and wide.vals.dtype == torch.float64
    csr = coo.convert(CSR).astype(nnz_dtype=torch.int32)
    assert csr.indptr.dtype == torch.int32
    big = COO(torch.tensor([0, 2**40]), torch.tensor([0, 1]), None, (2**40 + 1, 2))
    with pytest.raises(TypeMismatchError):
        big.astype(id_dtype=torch.int32)


def test_contexts():
    row, col, vals = MATRICES["square"](False)
    coo = COO.new(t(row), t(col), t(vals))
    assert coo.context == HostContext()
    assert context_for("cpu").is_equivalent(HostContext())
    cuda0 = DeviceContext(torch.device("cuda", 0))
    assert cuda0.is_equivalent(context_for(torch.device("cuda", 0)))
    assert not cuda0.is_equivalent(DeviceContext(torch.device("cuda", 1)))
    assert not cuda0.is_equivalent(HostContext())
    with pytest.raises(ValueError):
        DeviceContext(torch.device("cpu"))
    assert coo.to_device(CPU).context == HostContext() and coo.to_host().context == HostContext()


def test_dispatch_auto_conversion():
    row, col, vals = MATRICES["square"](False)
    coo = COO.new(t(row), t(col), t(vals))
    op = sbt.Operation("nnz_of_csr")
    op.register((CSR,), lambda fmts, params: (type(fmts[0]), fmts[0].nnz + params))
    assert op.execute(1, coo) == (CSR, coo.nnz + 1)
    converted, _ = op.execute_cached(0, coo)
    assert isinstance(converted[0], CSR)
    with pytest.raises(DirectExecutionNotAvailableError):
        op.execute(0, coo, convert_input=False)
    only_dia = sbt.Operation("dia_only", graph=ConversionGraph())
    only_dia.register((DIA,), lambda fmts, params: None)
    with pytest.raises(FunctionNotFoundError):
        only_dia.execute(None, coo)


def test_class_matcher_cover():
    m = sbt.ClassMatcher()
    m.register(["a", "b"], lambda: "ab")
    m.register(["c"], lambda: "c")
    m.register(["a"], lambda: "a")
    assert sorted(m.match(["a", "b", "c"])) == ["ab", "c"]
    with pytest.raises(FunctionNotFoundError):
        m.match(["d"])


def test_interop_carries_bf16_band():
    import jax.numpy as jnp

    row, col, vals = banded_triplets(5, 40, 40, (-2, 0, 3))
    want = ref.COO.new(row, col, vals, (40, 40)).convert(ref.CSR)
    want = ref_convert(want, RefDIA).astype(jnp.bfloat16)
    port = from_reference(want, CPU)
    assert port.data.dtype == torch.bfloat16 and port.offsets.dtype == torch.int32
    np.testing.assert_array_equal(
        to_numpy(port)["data"], np.asarray(want.data).astype(np.float32)
    )
    with pytest.raises(TypeMismatchError):
        from_reference(object(), CPU)


def test_port_imports_no_jax():
    code = (
        "import sys, sparsebase_tpu_torch, sparsebase_tpu_torch.interop, sparsebase_tpu_torch.parallel;"
        "import sparsebase_tpu_torch.parallel.collectives, sparsebase_tpu_torch.parallel.sharded2d;"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'sparsebase_tpu')];"
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
    for path in [REPO / "chip_smoke.py", *sorted((REPO / "tools").glob("torch_*.py")),
                 *sorted((REPO / "sparsebase_tpu_torch").rglob("*.py"))]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in ("jax", "sparsebase_tpu"), f"{path}: {line}"


# -- CSC, ELL, DenseArray, PaddedCSR ---------------------------------------------

GOLDEN = REPO / "tests" / "golden"


def golden_port_csr(name):
    indptr = np.loadtxt(GOLDEN / name / "csr_indptr.txt", dtype=np.int64)
    indices = np.loadtxt(GOLDEN / name / "csr_indices.txt", dtype=np.int32)
    n = indptr.size - 1
    return CSR(t(indptr), t(indices), None, (n, n))


@pytest.mark.parametrize("name", ["ash958_sym", "g960"])
def test_csc_equals_reference_library(name):
    csc = golden_port_csr(name).convert(CSC)
    assert isinstance(csc, CSC) and csc.indptr.dtype == torch.int64 and csc.indices.dtype == torch.int32
    np.testing.assert_array_equal(csc.indptr.numpy(), np.loadtxt(GOLDEN / name / "csc_indptr.txt", dtype=np.int64))
    np.testing.assert_array_equal(csc.indices.numpy(), np.loadtxt(GOLDEN / name / "csc_indices.txt", dtype=np.int64))
    back = csc.convert(CSR)  # the stable transpose gives the source back
    src = golden_port_csr(name)
    assert torch.equal(back.indptr, src.indptr) and torch.equal(back.indices, src.indices)


def canonical_entries(fmt_np):
    """(row, col, val) of a CSR/CSC/COO's numpy arrays, sorted."""
    if "row" in fmt_np:
        row, col = fmt_np["row"], fmt_np["col"]
    else:
        major = np.repeat(np.arange(fmt_np["indptr"].size - 1), np.diff(fmt_np["indptr"]))
        row, col = fmt_np["indices"], major
    vals = fmt_np["vals"] if fmt_np["vals"] is not None else np.zeros(row.size)
    order = np.lexsort((vals, col, row))
    return row[order], col[order], vals[order]


# edge -> (port source from a COO, reference source from a COO, target class names)
EDGES = {
    "COO->CSC": (lambda c: c, lambda c: c, "CSC"),
    "CSC->COO": (lambda c: c.convert(CSC), lambda c: c.convert(ref.CSC), "COO"),
    "CSR->CSC": (lambda c: c.convert(CSR), lambda c: c.convert(ref.CSR), "CSC"),
    "CSC->CSR": (lambda c: c.convert(CSC), lambda c: c.convert(ref.CSC), "CSR"),
    "CSR->ELL": (lambda c: c.convert(CSR), lambda c: c.convert(ref.CSR), "ELL"),
    "ELL->CSR": (lambda c: c.convert(CSR).convert(ELL), lambda c: c.convert(ref.CSR).convert(RefELL), "CSR"),
}


@pytest.mark.parametrize("pattern", [False, True], ids=["valued", "pattern"])
@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("edge", sorted(EDGES))
def test_new_edges_match_reference(edge, name, pattern):
    port_src, ref_src, target = EDGES[edge]
    row, col, vals = MATRICES[name](pattern)
    shape = (int(row.max()) + 1, int(col.max()) + 1)
    port_from = port_src(COO.new(t(row), t(col), t(vals), shape))
    ref_from = ref_src(ref.COO.new(row, col, vals, shape))
    port_cls = {"CSC": CSC, "COO": COO, "CSR": CSR, "ELL": ELL}[target]
    got = port_from.convert(port_cls)
    want = ref_convert(ref_from, getattr(ref, target) if target != "ELL" else RefELL)
    assert type(got) is port_cls
    assert_same(got, want)  # both sorts are stable: values equal in place
    if target != "ELL":
        got_np, want_np = to_numpy(got), to_numpy(from_reference(want, CPU))
        for a, b in zip(canonical_entries(got_np), canonical_entries(want_np)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.to_dense().numpy(), np.asarray(want.to_dense()))


def test_ell_width_below_max_degree_raises_like_reference():
    from sparsebase_tpu.convert.kernels import csr_to_ell as ref_csr_to_ell

    from sparsebase_tpu_torch.convert.kernels import csr_to_ell

    row, col, vals = MATRICES["square"](False)
    csr = COO.new(t(row), t(col), t(vals)).convert(CSR)
    want = ref.COO.new(row, col, vals).convert(ref.CSR)
    max_deg = int(csr.degrees().max())
    with pytest.raises(ValueError):
        csr_to_ell(csr, width=max_deg - 1)
    with pytest.raises(ValueError):
        ref_csr_to_ell(want, width=max_deg - 1)
    wide = csr_to_ell(csr, width=max_deg + 3)
    assert wide.width == max_deg + 3
    assert_same(wide, ref_csr_to_ell(want, width=max_deg + 3))
    assert wide.nnz == csr.nnz
    np.testing.assert_array_equal(wide.convert(CSR).to_dense().numpy(), csr.to_dense().numpy())


@pytest.mark.parametrize("which", ["rows", "cols", "both"])
def test_permute_2d_on_ell_matches_reference(which):
    from sparsebase_tpu.ops.permute import permute_2d as ref_permute_2d

    from sparsebase_tpu_torch.ops.permute import permute_2d

    row, col, vals = MATRICES["square"](False)
    n = 60
    perm = np.random.default_rng(9).permutation(n).astype(np.int32)
    ro = perm if which in ("rows", "both") else None
    co = perm[::-1].copy() if which in ("cols", "both") else None
    ell = COO.new(t(row), t(col), t(vals), (n, n)).convert(CSR).convert(ELL)
    want = ref_permute_2d(ref.COO.new(row, col, vals, (n, n)).convert(ref.CSR).convert(RefELL), ro, co)
    got = permute_2d(ell, t(ro), t(co))
    assert isinstance(got, ELL)
    assert_same(got, want)
    # the same matrix as the permuted CSR
    csr = permute_2d(ell.convert(CSR), t(ro), t(co))
    for key in ("indptr", "indices", "vals"):
        np.testing.assert_array_equal(to_numpy(got.convert(CSR))[key], to_numpy(csr)[key], err_msg=key)


@pytest.mark.parametrize("pattern", [False, True], ids=["valued", "pattern"])
def test_spmv_ell_matches_reference(pattern):
    from sparsebase_tpu.models.pipelines import spmv_ell as ref_spmv_ell

    row, col, vals = MATRICES["wide"](pattern)
    shape = (40, 90)
    x = np.random.default_rng(10).standard_normal(90).astype(np.float32)
    ell = COO.new(t(row), t(col), t(vals), shape).convert(CSR).convert(ELL)
    want = ref_spmv_ell(ref.COO.new(row, col, vals, shape).convert(ref.CSR).convert(RefELL), x)
    got = sbt.spmv(ell, t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), sbt.spmv(ell.convert(CSR), t(x)).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["pow2", "pow2_half", "exact-buckets", "rows-full", "pattern"])
def test_pad_csr_matches_reference_and_unpads(case):
    from sparsebase_tpu.formats.padded import next_bucket as ref_next_bucket
    from sparsebase_tpu.formats.padded import pad_csr as ref_pad_csr

    from sparsebase_tpu_torch.formats import next_bucket, pad_csr

    row, col, vals = MATRICES["tall"](case == "pattern")
    shape = (90, 30)
    csr = COO.new(t(row), t(col), t(vals), shape).convert(CSR)
    want_csr = ref.COO.new(row, col, vals, shape).convert(ref.CSR)
    kwargs = {"pow2_half": dict(policy="pow2_half"), "exact-buckets": dict(row_bucket=90, nnz_bucket=300),
              "rows-full": dict(row_bucket=90, nnz_bucket=512)}.get(case, {})
    got, want = pad_csr(csr, **kwargs), ref_pad_csr(want_csr, **kwargs)
    assert got.padded_shape == want.padded_shape and got.nnz == want.nnz and got.shape == want.shape
    assert_same(got, want)
    if case == "rows-full":
        assert got.padded_shape == (91, 30)  # one row added to hold the pad entries
    back = got.unpad()
    np.testing.assert_array_equal(back.indptr.numpy(), csr.indptr.numpy())
    np.testing.assert_array_equal(back.indices.numpy(), csr.indices.numpy())
    np.testing.assert_allclose(sbt.spmv(got.csr, torch.ones(30))[:90].numpy(), sbt.spmv(csr, torch.ones(30)).numpy(),
                               rtol=1e-6, atol=1e-6)
    assert got.context == HostContext()
    for x in (0, 1, 5, 96, 97, 1000):
        for policy in ("pow2", "pow2_half"):
            assert next_bucket(x, policy) == ref_next_bucket(x, policy)
    with pytest.raises(ValueError):
        pad_csr(csr, row_bucket=10)


@pytest.mark.parametrize("name", ["ash958_sym", "g960"])
def test_permute_1d_equals_reference_library(name):
    from sparsebase_tpu_torch.formats import DenseArray
    from sparsebase_tpu_torch.ops.permute import PermuteOrderOne, permute_1d

    order = np.loadtxt(GOLDEN / name / "degree_order.txt", dtype=np.int32)
    degs = np.loadtxt(GOLDEN / name / "degrees.txt", dtype=np.int32)
    got = permute_1d(DenseArray.new(t(degs)), t(order))
    assert isinstance(got, DenseArray) and got.shape == (degs.size,)
    np.testing.assert_array_equal(got.vals.numpy(), np.loadtxt(GOLDEN / name / "permute1d_degrees.txt", dtype=np.int64))
    assert PermuteOrderOne(t(order)).get_permutation(got.astype(value_dtype=torch.int64)).vals.dtype == torch.int64


def test_from_reference_tells_csc_from_csr():
    row, col, vals = MATRICES["wide"](False)
    want = ref.COO.new(row, col, vals, (40, 90)).convert(ref.CSC)
    got = from_reference(want, CPU)
    assert isinstance(got, CSC) and not isinstance(got, CSR)
    np.testing.assert_array_equal(got.to_dense().numpy(), np.asarray(want.to_dense()))
    assert_same(got, want)


@pytest.mark.parametrize("kind", ["CSC", "ELL", "DenseArray", "PaddedCSR"])
def test_new_formats_round_trip_through_interop(kind):
    from sparsebase_tpu.formats.array import DenseArray as RefDenseArray
    from sparsebase_tpu.formats.padded import pad_csr as ref_pad_csr

    row, col, vals = MATRICES["square"](False)
    csr = ref.COO.new(row, col, vals, (60, 60)).convert(ref.CSR)
    want = {"CSC": lambda: csr.convert(ref.CSC), "ELL": lambda: csr.convert(RefELL),
            "DenseArray": lambda: RefDenseArray.new(vals), "PaddedCSR": lambda: ref_pad_csr(csr)}[kind]()
    got = from_reference(want, CPU)
    assert type(got).__name__ == kind
    for key, value in to_numpy(got).items():
        if key in ("shape", "nnz"):
            assert value == (want.shape if key == "shape" else want.nnz)
            continue
        ref_arr = getattr(want.csr if kind == "PaddedCSR" else want, key)
        np.testing.assert_array_equal(value, np.asarray(ref_arr), err_msg=key)
    assert got.context == HostContext()
    if kind != "DenseArray":
        assert got.to_host().shape == want.shape


@pytest.mark.parametrize("name", ["ID_DTYPES", "NNZ_DTYPES", "VALUE_DTYPES", "FLOAT_DTYPES"])
def test_dtype_universes_match_jax(name):
    """The reference's CMake type lists, as torch dtypes in the JAX
    package's order."""
    from sparsebase_tpu import utils as ref_utils

    got = [str(d).removeprefix("torch.") for d in getattr(sbt.utils, name)]
    assert got == [np.dtype(d).name for d in getattr(ref_utils, name)]


# case -> the route csr_to_dia takes; rows hold the columns {i - 2, i, i + 3}
# in the matrix, ascending, unless the case changes them
DIA_ROUTES = {
    "ascending": "scatter", "repeated": "accumulate", "unordered": "accumulate", "pattern": "scatter",
    "empty": "scatter", "empty-rows": "scatter", "one-entry": "scatter", "wide": "scatter", "tall": "scatter",
    "float64": "scatter", "bfloat16": "scatter",
}


def dia_case(case):
    """(indptr, indices, values as float32 or float64, shape); the first value
    is an explicit -0.0."""
    n, m = {"wide": (6, 15), "tall": (15, 6)}.get(case, (12, 12))
    rows = [[c for c in (i - 2, i, i + 3) if 0 <= c < m] for i in range(n)]
    if case == "empty":
        rows = [[] for _ in range(n)]
    if case == "one-entry":
        rows = [[5] if i == 3 else [] for i in range(n)]
    if case == "empty-rows":
        rows[0] = rows[5] = rows[-1] = []
    if case == "repeated":
        rows[4] = [2, 4, 4, 7]
    if case == "unordered":
        rows[4] = rows[4][::-1]
    indptr = np.cumsum([0] + [len(r) for r in rows]).astype(np.int64)
    indices = np.array([c for r in rows for c in r], np.int32)
    rng = np.random.default_rng(11)
    if case == "bfloat16":
        vals = (rng.integers(-8, 9, indices.size) / 2).astype(np.float32)  # exact in bfloat16
    else:
        vals = rng.standard_normal(indices.size).astype(np.float64 if case == "float64" else np.float32)
    vals[:1] = -0.0
    return indptr, indices, vals, (n, m)


def value_bits(a):
    """The bits of each value: an integer view of the same width."""
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32, 8: np.int64}[a.dtype.itemsize])


@pytest.mark.parametrize("case", sorted(DIA_ROUTES))
def test_csr_to_dia_routes_match_reference(case):
    """Both routes of the port's ``csr_to_dia`` give the JAX package's band
    bit for bit (an explicit -0.0 becomes +0.0 on both), and the route's
    counter moves by one."""
    import ml_dtypes

    from sparsebase_tpu.convert.kernels import csr_to_dia as ref_csr_to_dia

    from sparsebase_tpu_torch.convert.kernels import csr_to_dia
    from sparsebase_tpu_torch.utils import tracing

    indptr, indices, vals, shape = dia_case(case)
    port_vals, ref_vals = t(vals), vals
    if case == "pattern":
        port_vals = ref_vals = None
    elif case == "bfloat16":
        port_vals, ref_vals = port_vals.to(torch.bfloat16), vals.astype(ml_dtypes.bfloat16)
    before = tracing.counters()
    got = csr_to_dia(CSR.new(t(indptr), t(indices), port_vals, shape, sort=False))
    after = tracing.counters()
    want = ref_csr_to_dia(ref.CSR.new(indptr, indices, ref_vals, shape, sort=False))
    route = DIA_ROUTES[case]
    other = {"scatter": "accumulate", "accumulate": "scatter"}[route]
    assert after.get(f"csr_to_dia.{route}", 0) == before.get(f"csr_to_dia.{route}", 0) + 1
    assert after.get(f"csr_to_dia.{other}", 0) == before.get(f"csr_to_dia.{other}", 0)
    assert got.shape == shape and got.offsets.tolist() == np.asarray(want.offsets).tolist()
    data = got.data.view(torch.int16) if got.data.dtype == torch.bfloat16 else got.data
    assert got.data.dtype == (torch.float32 if ref_vals is None else port_vals.dtype)
    np.testing.assert_array_equal(value_bits(data.numpy()), value_bits(want.data))
    assert not (torch.signbit(got.data) & (got.data == 0)).any()  # no -0.0 stored
