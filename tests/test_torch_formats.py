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

import sparsebase_tpu_torch as sbt  # noqa: E402
from sparsebase_tpu_torch import COO, CSR, DIA  # noqa: E402
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
        "import sys, sparsebase_tpu_torch, sparsebase_tpu_torch.interop;"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'sparsebase_tpu')];"
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
    for path in [REPO / "chip_smoke.py", *sorted((REPO / "sparsebase_tpu_torch").rglob("*.py"))]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in ("jax", "sparsebase_tpu"), f"{path}: {line}"
