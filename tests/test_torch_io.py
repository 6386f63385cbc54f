"""Port parity for I/O, objects and the IOBase façade, on the CPU.

Every case of ``tests/test_io.py`` is read by the JAX package and by the
port (``device="cpu"``), and the two results must have equal arrays,
dtypes and shapes. The port's writers must write the same bytes as the JAX
writers from the same arrays (MTX in every field and symmetry, through the
native formatter and through Python; edge list; METIS; PaToH; SBFF), each
package must read the other's SBFF files, and both must read the golden
files of ``tests/golden``. Values are compared exactly: both packages
parse the same text into the same types.
"""

import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from sparsebase_tpu import io as rio  # noqa: E402
from sparsebase_tpu.bases import IOBase as RefIOBase  # noqa: E402
from sparsebase_tpu.formats.array import DenseArray as RefDenseArray  # noqa: E402
from sparsebase_tpu.formats.coo import COO as RefCOO  # noqa: E402
from sparsebase_tpu.formats.csr import CSR as RefCSR  # noqa: E402
from sparsebase_tpu.objects import Graph as RefGraph  # noqa: E402

import sparsebase_tpu_torch.io as pio  # noqa: E402
from sparsebase_tpu_torch import COO, CSR, DenseArray, Graph, HyperGraph, IOBase, set_config  # noqa: E402
from sparsebase_tpu_torch.config import get_config  # noqa: E402
from sparsebase_tpu_torch.interop import from_reference, to_numpy  # noqa: E402
from sparsebase_tpu_torch.io import fastio  # noqa: E402
from sparsebase_tpu_torch.utils.exceptions import ReaderError, WriterError  # noqa: E402

CPU = "cpu"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

MTX_GENERAL = """%%MatrixMarket matrix coordinate integer general
%comment
3 3 4
1 2 1
1 3 2
2 1 3
3 1 4
"""
MTX_PATTERN = """%%MatrixMarket matrix coordinate pattern general
3 3 4
1 2
1 3
2 1
3 1
"""
MTX_SYMMETRIC = """%%MatrixMarket matrix coordinate real symmetric
3 3 3
1 1 1.0
2 1 2.0
3 2 3.0
"""
MTX_SKEW = """%%MatrixMarket matrix coordinate real skew-symmetric
3 3 2
2 1 2.0
3 2 3.0
"""
MTX_ARRAY = """%%MatrixMarket matrix array real general
3 2
1.0
0.0
2.0
0.0
3.0
4.0
"""
MTX_COMPLEX = "%%MatrixMarket matrix coordinate complex general\n2 2 2\n1 1 1.5 -2.0\n2 2 0.0 3.0\n"
MTX_COMPLEX_ARRAY = "%%MatrixMarket matrix array complex general\n2 1 \n1.0 2.0\n0.0 -1.0\n"
MTX_SCI = "%%MatrixMarket matrix coordinate real general\n2 2 2\n1 1 1.5e-3\n2 2 -2.25E+2\n"
MTX_UNSORTED = ("%%MatrixMarket matrix coordinate pattern general\n4 4 5\n1 2\n2 1\n3 4\n4 4\n2 3\n")
MTX_INT_SKEW = ("%%MatrixMarket matrix coordinate integer skew-symmetric\n4 4 3\n2 1 5\n3 1 2\n4 3 7\n")
MTX_REAL_SYM = ("%%MatrixMarket matrix coordinate real symmetric\n4 4 4\n1 1 1.5\n2 1 -2\n3 2 0.5\n4 4 3\n")
MTX_CASES = {
    "general": MTX_GENERAL, "pattern": MTX_PATTERN, "symmetric": MTX_SYMMETRIC, "skew": MTX_SKEW,
    "sci": MTX_SCI, "unsorted": MTX_UNSORTED, "int_skew": MTX_INT_SKEW, "real_sym": MTX_REAL_SYM,
}

METIS_PLAIN = "7 11\n5 3 2\n1 3 4\n5 4 2 1\n2 3 6 7\n1 3 6\n5 4 7\n6 4\n"
METIS_WEIGHTED = ("7 11 001\n5 1 3 2 2 1\n1 1 3 2 4 1\n5 3 4 2 2 2 1 2\n2 1 3 2 6 2 7 5\n1 1 3 3 6 2\n"
                  "5 2 4 2 7 6\n6 6 4 5\n")
METIS_VWGT = "7 11 010 1\n4 5 3 2\n2 1 3 4\n5 5 4 2 1\n3 2 3 6 7\n1 1 3 6\n6 5 4 7\n2 6 4\n"
PATOH_PLAIN = "0 6 4 12\n0 2\n0 1 3\n3 4 5\n2 4 5 3\n"
PATOH_WEIGHTED = "1 6 4 12 3\n2 1 3\n1 1 2 4\n3 4 5 6\n1 3 5 6 4\n1 2 3 4 5 6\n"
EDGES = "0 1\n1 2\n2 0\n"
EDGES_WEIGHTED = "0 1 0.5\n1 2 1.5\n% comment\n2 0 2.5\n"
EDGES_DUPS = "0 0\n0 1\n0 1\n1 0\n"


@pytest.fixture
def native_toggles():
    """Saves the config and puts it back after the test."""
    saved = get_config()
    yield
    set_config(**{f: getattr(saved, f) for f in saved.__dataclass_fields__})


def write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def np_dtype(t: torch.Tensor):
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def assert_same_arrays(port, ref, names):
    for name in names:
        p, r = getattr(port, name), getattr(ref, name)
        if r is None:
            assert p is None, name
            continue
        r = np.asarray(r)
        assert p.device.type == "cpu"
        assert np_dtype(p) == r.dtype, (name, p.dtype, r.dtype)
        assert tuple(p.shape) == r.shape, name
        np.testing.assert_array_equal(p.numpy(), r, err_msg=name)
    assert tuple(port.shape) == tuple(ref.shape)


def canonical(row, col, vals):
    """The values in (row, col, value) order."""
    return vals[np.lexsort((vals, col, row))]


def assert_same_coo(port, ref):
    assert isinstance(port, COO)
    assert_same_arrays(port, ref, ("row", "col", "vals"))


def assert_same_csr(port, ref):
    """indptr by value (the port keeps int64 offsets), the rest exactly."""
    assert isinstance(port, CSR)
    np.testing.assert_array_equal(port.indptr.numpy(), np.asarray(ref.indptr))
    assert_same_arrays(port, ref, ("indices", "vals"))


# -- readers -------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(MTX_CASES))
@pytest.mark.parametrize("zero_index", [True, False])
@pytest.mark.parametrize("upper", [False, True])
@pytest.mark.parametrize("pigo", [False, True])
def test_mtx_read_coo_matches_reference(tmp_path, name, zero_index, upper, pigo):
    p = write(tmp_path, "m.mtx", MTX_CASES[name])
    ref_cls, port_cls = (rio.PigoMTXReader, pio.PigoMTXReader) if pigo else (rio.MTXReader, pio.MTXReader)
    ref = ref_cls(p, convert_to_zero_index=zero_index, upper_triangle=upper).read_coo()
    port = port_cls(p, convert_to_zero_index=zero_index, upper_triangle=upper, device=CPU).read_coo()
    assert_same_arrays(port, ref, ("row", "col"))
    if ref.vals is None:
        assert port.vals is None
    else:  # the JAX Pigo reader leaves duplicates' payload order open: compare within each coordinate
        assert port.vals.numpy().dtype == np.asarray(ref.vals).dtype
        np.testing.assert_array_equal(canonical(port.row.numpy(), port.col.numpy(), port.vals.numpy()),
                                      canonical(*map(np.asarray, (ref.row, ref.col, ref.vals))))


@pytest.mark.parametrize("name", sorted(MTX_CASES))
def test_mtx_read_csr_matches_reference(tmp_path, name):
    p = write(tmp_path, "m.mtx", MTX_CASES[name])
    assert_same_csr(pio.MTXReader(p, device=CPU).read_csr(), rio.MTXReader(p).read_csr())


@pytest.mark.parametrize("text", [MTX_ARRAY, MTX_COMPLEX_ARRAY], ids=["real", "complex"])
@pytest.mark.parametrize("complex_values", [False, True])
def test_mtx_array_format_matches_reference(tmp_path, text, complex_values):
    p = write(tmp_path, "a.mtx", text)
    rdt, pdt = (np.complex128, torch.complex128) if complex_values else (None, None)
    ref_coo = rio.MTXReader(p, value_dtype=rdt).read_coo()
    assert_same_coo(pio.MTXReader(p, value_dtype=pdt, device=CPU).read_coo(), ref_coo)
    ref_arr = rio.MTXReader(p, value_dtype=rdt).read_array()
    assert_same_arrays(pio.MTXReader(p, value_dtype=pdt, device=CPU).read_array(), ref_arr, ("vals",))
    assert_same_arrays(pio.PigoMTXReader(p, value_dtype=pdt, device=CPU).read_array(), ref_arr, ("vals",))


def test_mtx_read_array_of_coordinate_file_matches_reference(tmp_path):
    p = write(tmp_path, "m.mtx", MTX_GENERAL)
    assert_same_arrays(pio.MTXReader(p, device=CPU).read_array(), rio.MTXReader(p).read_array(), ("vals",))


@pytest.mark.parametrize("complex_values", [False, True])
def test_mtx_complex_coordinate_matches_reference(tmp_path, complex_values):
    p = write(tmp_path, "c.mtx", MTX_COMPLEX)
    rdt, pdt = (np.complex128, torch.complex128) if complex_values else (None, None)
    for port_cls, ref_cls in ((pio.MTXReader, rio.MTXReader), (pio.PigoMTXReader, rio.PigoMTXReader)):
        assert_same_coo(port_cls(p, value_dtype=pdt, device=CPU).read_coo(), ref_cls(p, value_dtype=rdt).read_coo())


@pytest.mark.parametrize("text", [
    "%%MatrixMarket tensor coordinate real general\n1 1 0\n",
    "%%MatrixMarket vector coordinate real general\n1 1 0\n",
    "%%MatrixMarket matrix coordinate real hermitian\n1 1 0\n",
], ids=["tensor", "vector", "hermitian"])
def test_mtx_bad_header_raises_in_both(tmp_path, text):
    p = write(tmp_path, "m.mtx", text)
    with pytest.raises(rio.mtx.ReaderError):
        rio.MTXReader(p)
    with pytest.raises(ReaderError):
        pio.MTXReader(p, device=CPU)


@pytest.mark.parametrize("text", [
    "%%MatrixMarket matrix coordinate complex general\n2 2 1\n1 1 1.5\n",  # no imaginary column
    "%%MatrixMarket matrix coordinate real general\n2 2 3\n1 1 1.0\n2 2 2.0\n",  # wrong entry count
    "%%MatrixMarket matrix coordinate real general\n2 2\n1 1 1.0\n",  # size line of 2
], ids=["no-imaginary", "count", "size-line"])
@pytest.mark.parametrize("pigo", [False, True])
def test_mtx_malformed_body_raises_in_both(tmp_path, text, pigo):
    p = write(tmp_path, "m.mtx", text)
    ref_cls, port_cls = (rio.PigoMTXReader, pio.PigoMTXReader) if pigo else (rio.MTXReader, pio.MTXReader)
    with pytest.raises(rio.mtx.ReaderError):
        ref_cls(p).read_coo()
    with pytest.raises(ReaderError):
        port_cls(p, device=CPU).read_coo()


@pytest.mark.parametrize("pigo", [False, True])
def test_mtx_entry_outside_its_size_line_raises(tmp_path, pigo):
    p = write(tmp_path, "m.mtx", "%%MatrixMarket matrix coordinate real general\n2 2 2\n1 1 1.0\n3 1 2.0\n")
    with pytest.raises(ReaderError, match="outside"):
        (pio.PigoMTXReader if pigo else pio.MTXReader)(p, device=CPU).read_coo()


@pytest.mark.parametrize("reader", ["mtx", "pigo", "edge-list"])
def test_id_past_its_index_type_raises(tmp_path, reader):
    """An id of 2^32 + 1 would wrap into a 10 x 10 file's int32 ids; the
    reader refuses it before the cast."""
    big = 2 ** 32 + 1
    if reader == "edge-list":
        p = write(tmp_path, "e.txt", f"0 1\n{big} 2\n")
        make = lambda: pio.EdgeListReader(p, id_dtype=torch.int32, device=CPU)  # noqa: E731
    else:
        p = write(tmp_path, "m.mtx", f"%%MatrixMarket matrix coordinate real general\n10 10 2\n1 1 1.0\n{big} 2 2.0\n")
        make = lambda: (pio.PigoMTXReader if reader == "pigo" else pio.MTXReader)(p, device=CPU)  # noqa: E731
    with pytest.raises(ReaderError, match="do not fit"):
        make().read_coo()


@pytest.mark.parametrize("golden", ["ash958_sym", "g960"])
@pytest.mark.parametrize("pigo", [False, True])
def test_golden_mtx_read_by_both(golden, pigo):
    p = os.path.join(GOLDEN, f"{golden}.mtx")
    ref = (RefIOBase.read_pigo_mtx_to_csr if pigo else RefIOBase.read_mtx_to_csr)(p)
    port = (IOBase.read_pigo_mtx_to_csr if pigo else IOBase.read_mtx_to_csr)(p, device=CPU)
    assert_same_csr(port, ref)
    np.testing.assert_array_equal(port.indptr.numpy(), np.loadtxt(os.path.join(GOLDEN, golden, "csr_indptr.txt")))
    np.testing.assert_array_equal(port.indices.numpy(),
                                  np.loadtxt(os.path.join(GOLDEN, golden, "csr_indices.txt")))


@pytest.mark.parametrize("golden", ["ash958_sym", "g960"])
def test_pigo_matches_plain_reader_on_golden(golden):
    p = os.path.join(GOLDEN, f"{golden}.mtx")
    a = pio.PigoMTXReader(p, device=CPU).read_coo()
    b = pio.MTXReader(p, device=CPU).read_coo()
    for name in ("row", "col", "vals"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_pigo_without_fastio_takes_the_numpy_parse(tmp_path, native_toggles):
    p = write(tmp_path, "m.mtx", MTX_REAL_SYM)
    fast = pio.PigoMTXReader(p, device=CPU).read_coo()
    set_config(use_fastio=False)
    slow = pio.PigoMTXReader(p, device=CPU).read_coo()
    assert_same_coo(slow, rio.MTXReader(p).read_coo())
    assert torch.equal(fast.row, slow.row) and torch.equal(fast.vals, slow.vals)


@pytest.mark.parametrize("text", [EDGES, EDGES_WEIGHTED, EDGES_DUPS], ids=["plain", "weighted", "dups"])
@pytest.mark.parametrize("opts", [
    {}, {"read_undirected": False}, {"remove_duplicates": True, "remove_self_edges": True, "read_undirected": False},
    {"remove_duplicates": True}, {"remove_self_edges": True},
], ids=["default", "directed", "dedup-directed", "dedup", "no-self"])
@pytest.mark.parametrize("pigo", [False, True])
def test_edge_list_matches_reference(tmp_path, text, opts, pigo):
    p = write(tmp_path, "e.txt", text)
    weighted = text is EDGES_WEIGHTED
    ref_cls, port_cls = ((rio.PigoEdgeListReader, pio.PigoEdgeListReader) if pigo
                         else (rio.EdgeListReader, pio.EdgeListReader))
    ref = ref_cls(p, weighted=weighted, **opts).read_coo()
    port = port_cls(p, weighted=weighted, device=CPU, **opts).read_coo()
    assert_same_coo(port, ref)
    assert_same_csr(port_cls(p, weighted=weighted, device=CPU, **opts).read_csr(),
                    ref_cls(p, weighted=weighted, **opts).read_csr())


@pytest.mark.parametrize("text", [METIS_PLAIN, METIS_WEIGHTED, METIS_VWGT], ids=["plain", "edge-w", "vertex-w"])
@pytest.mark.parametrize("zero_index", [True, False])
def test_metis_graph_matches_reference(tmp_path, text, zero_index):
    p = write(tmp_path, "g.graph", text)
    ref = rio.MetisGraphReader(p, convert_to_zero_index=zero_index).read_graph()
    port = pio.MetisGraphReader(p, convert_to_zero_index=zero_index, device=CPU).read_graph()
    assert isinstance(port, Graph)
    assert (port.n, port.m, port.ncon) == (ref.n, ref.m, ref.ncon)
    assert_same_coo(port.connectivity, ref.connectivity)
    if ref.vertex_weights is None:
        assert port.vertex_weights is None
    else:
        assert len(port.vertex_weights) == len(ref.vertex_weights)
        for pw, rw in zip(port.vertex_weights, ref.vertex_weights):
            assert_same_arrays(pw, rw, ("vals",))
    port.verify_structure()


@pytest.mark.parametrize("text", [PATOH_PLAIN, PATOH_WEIGHTED], ids=["plain", "weighted"])
def test_patoh_matches_reference(tmp_path, text):
    p = write(tmp_path, "h.patoh", text)
    ref = rio.PatohReader(p).read_hypergraph()
    port = pio.PatohReader(p, device=CPU).read_hypergraph()
    assert isinstance(port, HyperGraph)
    assert (port.num_nets, port.num_cells, port.base_type, port.constraint_num) == (
        ref.num_nets, ref.num_cells, ref.base_type, ref.constraint_num)
    assert_same_arrays(port.connectivity, ref.connectivity, ("indptr", "indices"))
    assert_same_arrays(port.xnet_csr, ref.xnet_csr, ("indptr", "indices"))
    for name in ("net_weights", "cell_weights"):
        if getattr(ref, name) is None:
            assert getattr(port, name) is None
        else:
            assert_same_arrays(getattr(port, name), getattr(ref, name), ("vals",))
    port.verify_structure()


# -- writers: the same bytes -----------------------------------------------------


def matrix(seed, n=40, nnz=300, kind="real"):
    """A seeded matrix with duplicates, a diagonal and values that exercise
    the formatter (tiny, huge, negative zero, whole numbers)."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n, nnz).astype(np.int32)
    col = rng.integers(0, n, nnz).astype(np.int32)
    row[:5] = col[:5] = np.arange(5)
    if kind == "integer":
        vals = rng.integers(-1000, 1000, nnz).astype(np.int32)
    elif kind == "complex":
        vals = (rng.standard_normal(nnz) + 1j * rng.standard_normal(nnz)).astype(np.complex64)
    else:
        vals = (rng.standard_normal(nnz) * 10.0 ** rng.integers(-12, 20, nnz)).astype(np.float32)
        vals[:6] = [-0.0, 1e-5, 1e16, 3.0, 0.1, -2.5e-7]
    order = np.lexsort((col, row))
    return row[order], col[order], vals[order], (n, n)


def ref_and_port_coo(row, col, vals, shape):
    ref = RefCOO.new(row.copy(), col.copy(), None if vals is None else vals.copy(), shape=shape)
    port = COO.new(torch.from_numpy(row.copy()), torch.from_numpy(col.copy()),
                   None if vals is None else torch.from_numpy(vals.copy()), shape)
    return ref, port


@pytest.mark.parametrize("field", ["real", "double", "integer", "pattern", "complex"])
@pytest.mark.parametrize("symmetry", ["general", "symmetric", "skew-symmetric"])
@pytest.mark.parametrize("native", [True, False])
def test_mtx_writer_bytes_match_reference(tmp_path, native_toggles, field, symmetry, native):
    set_config(use_fastio=native)
    kind = field if field in ("integer", "complex") else "real"
    ref, port = ref_and_port_coo(*matrix(3, kind=kind))
    rio.MTXWriter(str(tmp_path / "ref.mtx"), field=field, symmetry=symmetry).write_coo(ref)
    pio.MTXWriter(str(tmp_path / "port.mtx"), field=field, symmetry=symmetry).write_coo(port)
    assert (tmp_path / "port.mtx").read_bytes() == (tmp_path / "ref.mtx").read_bytes()


@pytest.mark.parametrize("what", ["coo-array", "csr", "array", "integer-of-floats"])
@pytest.mark.parametrize("native", [True, False])
def test_mtx_writer_other_forms_match_reference(tmp_path, native_toggles, what, native):
    set_config(use_fastio=native)
    row, col, vals, shape = matrix(4, n=12, nnz=30)
    ref, port = ref_and_port_coo(row, col, vals, shape)
    rp, pp = str(tmp_path / "ref.mtx"), str(tmp_path / "port.mtx")
    if what == "coo-array":
        rio.MTXWriter(rp, format="array").write_coo(ref)
        pio.MTXWriter(pp, format="array").write_coo(port)
    elif what == "csr":
        rio.MTXWriter(rp).write_csr(ref.convert(RefCSR))
        pio.MTXWriter(pp).write_csr(port.convert(CSR))
    elif what == "array":
        rio.MTXWriter(rp, format="array").write_array(RefDenseArray.new(vals.copy()))
        pio.MTXWriter(pp, format="array").write_array(DenseArray(torch.from_numpy(vals.copy())))
    else:  # int(v) of float values, as the integer field writes them
        rio.MTXWriter(rp, field="integer").write_coo(ref)
        pio.MTXWriter(pp, field="integer").write_coo(port)
    assert open(pp, "rb").read() == open(rp, "rb").read()


def test_mtx_formatter_matches_python_repr():
    """fastio's body lines against ``%d %d %r`` on float32 and float64
    values across the exponent range, with the special values."""
    rng = np.random.default_rng(5)
    bits = rng.integers(-(2 ** 63), 2 ** 63 - 1, 20_000, dtype=np.int64)
    f32 = (rng.standard_normal(20_000) * 10.0 ** rng.integers(-40, 39, 20_000)).astype(np.float32)
    special = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-5, 1e-4, 1e16, 1e15, 5e-324, 1.7976931348623157e308,
               9.999999999999999e15, 123456789012345678.0, 0.1, 2.0 ** 63, 1e22, 1e23]
    v = np.concatenate([bits.view(np.float64), f32.astype(np.float64), special])
    r = rng.integers(0, 2 ** 40, v.size)
    c = rng.integers(0, 2 ** 31, v.size)
    got = bytes(fastio.format_mtx(torch.from_numpy(r), torch.from_numpy(c), 1, dvals=torch.from_numpy(v)))
    want = "".join(f"{a + 1} {b + 1} {x!r}\n" for a, b, x in zip(r.tolist(), c.tolist(), v.tolist())).encode()
    assert got == want
    iv = rng.integers(-(2 ** 62), 2 ** 62, 500)
    assert bytes(fastio.format_mtx(None, None, 1, ivals=torch.from_numpy(iv))) == "".join(
        f"{x}\n" for x in iv.tolist()).encode()


def test_mtx_writer_round_trip_and_errors(tmp_path):
    ref, port = ref_and_port_coo(*matrix(6, kind="integer"))
    p = str(tmp_path / "rt.mtx")
    pio.MTXWriter(p, field="integer").write_coo(port)
    assert_same_coo(pio.MTXReader(p, device=CPU).read_coo(), rio.MTXReader(p).read_coo())
    with pytest.raises(WriterError):
        pio.MTXWriter(p, symmetry="hermitian")
    with pytest.raises(WriterError):
        pio.MTXWriter(p).write_coo(COO(port.row, port.col, None, port.shape))


@pytest.mark.parametrize("weighted", [False, True])
def test_edge_list_writer_bytes_match_reference(tmp_path, weighted):
    ref, port = ref_and_port_coo(*matrix(7, n=15, nnz=40))
    rio.EdgeListWriter(str(tmp_path / "r.txt"), weighted=weighted).write_coo(ref)
    pio.EdgeListWriter(str(tmp_path / "p.txt"), weighted=weighted).write_coo(port)
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "r.txt").read_bytes()
    pio.EdgeListWriter(str(tmp_path / "p2.txt"), weighted=weighted).write_csr(port.convert(CSR))
    assert (tmp_path / "p2.txt").read_bytes() == (tmp_path / "r.txt").read_bytes()


@pytest.mark.parametrize("text", [METIS_PLAIN, METIS_WEIGHTED, METIS_VWGT], ids=["plain", "edge-w", "vertex-w"])
def test_metis_writer_bytes_match_reference(tmp_path, text):
    p = write(tmp_path, "g.graph", text)
    ref = rio.MetisGraphReader(p).read_graph()
    rio.MetisGraphWriter(str(tmp_path / "r.graph")).write_graph(ref)
    pio.MetisGraphWriter(str(tmp_path / "p.graph")).write_graph(from_reference(ref, CPU))
    assert (tmp_path / "p.graph").read_bytes() == (tmp_path / "r.graph").read_bytes()


@pytest.mark.parametrize("text,flags", [
    (PATOH_PLAIN, {}), (PATOH_WEIGHTED, {}),
    (PATOH_WEIGHTED, {"is_zero_indexed": False, "is_edge_weighted": True, "is_vertex_weighted": True}),
], ids=["plain", "weighted", "weighted-flags"])
def test_patoh_writer_bytes_match_reference(tmp_path, text, flags):
    p = write(tmp_path, "h.patoh", text)
    ref = rio.PatohReader(p).read_hypergraph()
    rio.PatohWriter(str(tmp_path / "r.patoh"), **flags).write_hypergraph(ref)
    pio.PatohWriter(str(tmp_path / "p.patoh"), **flags).write_hypergraph(from_reference(ref, CPU))
    assert (tmp_path / "p.patoh").read_bytes() == (tmp_path / "r.patoh").read_bytes()


def sbff_cases():
    row, col, vals, shape = matrix(8)
    ref_coo, port_coo = ref_and_port_coo(row, col, vals, shape)
    ref_csr = ref_coo.convert(RefCSR)
    indptr = np.asarray(ref_csr.indptr)
    port_csr = CSR(torch.from_numpy(indptr.copy()), port_coo.col, port_coo.vals, shape)  # the same offset type
    arr = np.linspace(-1, 1, 9).astype(np.float64)
    return {
        "coo": (lambda p: rio.BinaryWriterOrderTwo(p).write_coo(ref_coo),
                lambda p: pio.BinaryWriterOrderTwo(p).write_coo(port_coo)),
        "pattern-csr": (lambda p: rio.BinaryWriterOrderTwo(p).write_csr(RefCSR.new(indptr, ref_csr.indices, None,
                                                                                     shape=shape)),
                        lambda p: pio.BinaryWriterOrderTwo(p).write_csr(CSR(port_csr.indptr, port_csr.indices,
                                                                             None, shape))),
        "csr": (lambda p: rio.BinaryWriterOrderTwo(p).write_csr(ref_csr),
                lambda p: pio.BinaryWriterOrderTwo(p).write_csr(port_csr)),
        "array": (lambda p: rio.BinaryWriterOrderOne(p).write_array(RefDenseArray.new(arr.copy())),
                  lambda p: pio.BinaryWriterOrderOne(p).write_array(DenseArray(torch.from_numpy(arr.copy())))),
    }


@pytest.mark.parametrize("case", ["coo", "pattern-csr", "csr", "array"])
def test_sbff_bytes_match_and_cross_read(tmp_path, case):
    write_ref, write_port = sbff_cases()[case]
    rp, pp = str(tmp_path / "r.sbff"), str(tmp_path / "p.sbff")
    write_ref(rp)
    write_port(pp)
    assert open(pp, "rb").read() == open(rp, "rb").read()
    # each package reads the other's file
    if case == "array":
        assert_same_arrays(pio.BinaryReaderOrderOne(rp, device=CPU).read_array(),
                           rio.BinaryReaderOrderOne(pp).read_array(), ("vals",))
        return
    if case == "coo":
        assert_same_coo(pio.BinaryReaderOrderTwo(rp, device=CPU).read_coo(), rio.BinaryReaderOrderTwo(pp).read_coo())
    else:
        port = pio.BinaryReaderOrderTwo(rp, device=CPU).read_csr()
        assert_same_arrays(port, rio.BinaryReaderOrderTwo(pp).read_csr(), ("indptr", "indices", "vals"))
    with pytest.raises(ReaderError):
        (pio.BinaryReaderOrderTwo(rp, device=CPU).read_csr() if case == "coo"
         else pio.BinaryReaderOrderTwo(rp, device=CPU).read_coo())


@pytest.mark.parametrize("golden", ["ash958_sym", "g960"])
def test_sbff_golden_written_by_the_reference_library(golden):
    """``coo.sbff`` and ``degree_order.sbff`` came from the reference C++
    library; both packages must read the same arrays from them."""
    p = os.path.join(GOLDEN, golden, "coo.sbff")
    assert_same_coo(pio.BinaryReaderOrderTwo(p, device=CPU).read_coo(), rio.BinaryReaderOrderTwo(p).read_coo())
    p = os.path.join(GOLDEN, golden, "degree_order.sbff")
    assert_same_arrays(pio.BinaryReaderOrderOne(p, device=CPU).read_array(),
                       rio.BinaryReaderOrderOne(p).read_array(), ("vals",))


def test_sbff_object_interop_round_trip(tmp_path):
    ref = rio.SbffObject("thing")
    ref.add_dimensions([3, 4])
    ref.add_array("a", np.arange(5, dtype=np.uint16))
    ref.add_array("b", np.linspace(0, 1, 3).astype(np.float32))
    port = from_reference(ref, CPU)
    out = to_numpy(port)
    assert out["name"] == "thing" and out["dimensions"] == [3, 4]
    for k in ("a", "b"):
        assert out["arrays"][k].dtype == ref.get_array(k).dtype
        np.testing.assert_array_equal(out["arrays"][k], ref.get_array(k))
    port.write(str(tmp_path / "p.sbff"))
    ref.write(str(tmp_path / "r.sbff"))
    assert (tmp_path / "p.sbff").read_bytes() == (tmp_path / "r.sbff").read_bytes()
    with pytest.raises(WriterError):
        pio.SbffObject("x").add_array("c", torch.zeros(2, dtype=torch.bfloat16))


# -- façade, objects, placement --------------------------------------------------


def test_iobase_matches_direct_calls(tmp_path):
    p = write(tmp_path, "m.mtx", MTX_REAL_SYM)
    e = write(tmp_path, "e.txt", EDGES_WEIGHTED)
    kw = {"device": CPU}
    pairs = [
        (IOBase.read_mtx_to_coo(p, **kw), pio.MTXReader(p, **kw).read_coo(), RefIOBase.read_mtx_to_coo(p)),
        (IOBase.read_pigo_mtx_to_coo(p, **kw), pio.PigoMTXReader(p, **kw).read_coo(),
         RefIOBase.read_pigo_mtx_to_coo(p)),
        (IOBase.read_edge_list_to_coo(e, weighted=True, **kw), pio.EdgeListReader(e, weighted=True, **kw).read_coo(),
         RefIOBase.read_edge_list_to_coo(e, weighted=True)),
        (IOBase.read_pigo_edge_list_to_coo(e, weighted=True, **kw),
         pio.PigoEdgeListReader(e, weighted=True, **kw).read_coo(),
         RefIOBase.read_pigo_edge_list_to_coo(e, weighted=True)),
    ]
    for via, direct, ref in pairs:
        assert_same_coo(via, ref)
        assert all(torch.equal(getattr(via, k), getattr(direct, k)) for k in ("row", "col", "vals"))
    csrs = [
        (IOBase.read_mtx_to_csr(p, **kw), RefIOBase.read_mtx_to_csr(p)),
        (IOBase.read_pigo_mtx_to_csr(p, **kw), RefIOBase.read_pigo_mtx_to_csr(p)),
        (IOBase.read_edge_list_to_csr(e, weighted=True, **kw), RefIOBase.read_edge_list_to_csr(e, weighted=True)),
        (IOBase.read_pigo_edge_list_to_csr(e, weighted=True, **kw),
         RefIOBase.read_pigo_edge_list_to_csr(e, weighted=True)),
    ]
    for via, ref in csrs:
        assert_same_csr(via, ref)
    a = write(tmp_path, "a.mtx", MTX_ARRAY)
    assert_same_arrays(IOBase.read_mtx_to_array(a, **kw), RefIOBase.read_mtx_to_array(a), ("vals",))
    # writers through the façade: the same bytes as the JAX façade's
    coo = IOBase.read_mtx_to_coo(p, **kw)
    ref_coo = RefIOBase.read_mtx_to_coo(p)
    for port_write, ref_write, obj, ref_obj in [
        (IOBase.write_coo_to_mtx, RefIOBase.write_coo_to_mtx, coo, ref_coo),
        (IOBase.write_csr_to_mtx, RefIOBase.write_csr_to_mtx, coo.convert(CSR), ref_coo.convert(RefCSR)),
        (IOBase.write_coo_to_binary, RefIOBase.write_coo_to_binary, coo, ref_coo),
        (IOBase.write_array_to_mtx, RefIOBase.write_array_to_mtx, DenseArray(coo.vals.clone()),
         RefDenseArray.new(np.asarray(ref_coo.vals).copy())),
        (IOBase.write_array_to_binary, RefIOBase.write_array_to_binary, DenseArray(coo.vals.clone()),
         RefDenseArray.new(np.asarray(ref_coo.vals).copy())),
    ]:
        port_write(obj, str(tmp_path / "p.out"))
        ref_write(ref_obj, str(tmp_path / "r.out"))
        assert (tmp_path / "p.out").read_bytes() == (tmp_path / "r.out").read_bytes(), port_write.__name__
    b = str(tmp_path / "m.sbff")
    IOBase.write_csr_to_binary(coo.convert(CSR), b)
    back = IOBase.read_binary_to_csr(b, device=CPU)
    assert all(torch.equal(getattr(back, k), getattr(coo.convert(CSR), k)) for k in ("indptr", "indices", "vals"))
    IOBase.write_coo_to_binary(coo, str(tmp_path / "m2.sbff"))
    assert torch.equal(IOBase.read_binary_to_coo(str(tmp_path / "m2.sbff"), device=CPU).row, coo.row)
    IOBase.write_array_to_binary(DenseArray(coo.vals), str(tmp_path / "a.sbff"))
    assert torch.equal(IOBase.read_binary_to_array(str(tmp_path / "a.sbff"), device=CPU).vals, coo.vals)


@pytest.mark.parametrize("how", ["mtx", "edgelist"])
def test_graph_constructors_match_reference(tmp_path, how):
    if how == "mtx":
        p = write(tmp_path, "m.mtx", MTX_GENERAL)
        ref, port = RefGraph.read_connectivity_from_mtx_to_coo(p), Graph.read_connectivity_from_mtx_to_coo(p, CPU)
        assert_same_coo(port.connectivity, ref.connectivity)
    else:
        p = write(tmp_path, "e.txt", "0 1\n1 2\n")
        ref = RefGraph.read_connectivity_from_edgelist_to_csr(p)
        port = Graph.read_connectivity_from_edgelist_to_csr(p, CPU)
        assert_same_csr(port.connectivity, ref.connectivity)
    assert (port.n, port.m, port.ncon) == (ref.n, ref.m, ref.ncon)
    port.verify_structure()
    assert repr(port) == repr(ref)


def test_hypergraph_and_graph_interop(tmp_path):
    hg = rio.PatohReader(write(tmp_path, "h.patoh", PATOH_WEIGHTED)).read_hypergraph()
    port = from_reference(hg, CPU)
    assert isinstance(port, HyperGraph) and repr(port) == repr(hg)
    out = to_numpy(port)
    np.testing.assert_array_equal(out["xnet"]["indices"], np.asarray(hg.xnet_csr.indices))
    np.testing.assert_array_equal(out["net_weights"], np.asarray(hg.net_weights.vals))
    np.testing.assert_array_equal(out["cell_weights"], np.asarray(hg.cell_weights.vals))
    assert (out["base_type"], out["constraint_num"]) == (hg.base_type, hg.constraint_num)
    g = rio.MetisGraphReader(write(tmp_path, "g.graph", METIS_VWGT)).read_graph()
    out = to_numpy(from_reference(g, CPU))
    assert (out["n"], out["m"], out["ncon"]) == (g.n, g.m, g.ncon)
    np.testing.assert_array_equal(out["connectivity"]["row"], np.asarray(g.connectivity.row))
    assert [w.tolist() for w in out["vertex_weights"]] == [np.asarray(w.vals).tolist() for w in g.vertex_weights]


def test_readers_default_to_the_card(tmp_path):
    """Without ``device=`` a reader places its format on CUDA; with no card
    it raises instead of reading onto the CPU."""
    p = write(tmp_path, "m.mtx", MTX_GENERAL)
    readers = [lambda: pio.MTXReader(p).read_coo(), lambda: pio.PigoMTXReader(p).read_coo(),
               lambda: IOBase.read_mtx_to_csr(p), lambda: pio.EdgeListReader(write(tmp_path, "e.txt", EDGES)),
               lambda: pio.BinaryReaderOrderTwo(p), lambda: Graph.read_connectivity_from_mtx_to_coo(p)]
    for read in readers:
        if torch.cuda.is_available():
            out = read()
            tensor = getattr(out, "row", getattr(out, "indptr", None))
            assert tensor is None or tensor.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                read()
