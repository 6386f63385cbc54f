"""Port parity for the host C++ libraries, on the CPU.

``sparsebase_tpu_torch.native`` (graphkit) and ``sparsebase_tpu_torch.io.
fastio`` are built from the port's own copies of the C++ sources; each
binding must give what the JAX package's binding gives on the same seeded
graph or file, exactly. ``RCMReorder``'s host route runs on graphkit where
it is built and must equal the reference library's goldens and the port's
``_rcm_host``; with ``use_graphkit=False`` it takes ``_rcm_host``.
"""

import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import sparsebase_tpu as ref_sb  # noqa: E402
from sparsebase_tpu import native as ref_native  # noqa: E402
from sparsebase_tpu.io import fastio as ref_fastio  # noqa: E402

from sparsebase_tpu_torch import CSR, ReorderBase, _build, native, set_config  # noqa: E402
from sparsebase_tpu_torch.config import get_config  # noqa: E402
from sparsebase_tpu_torch.io import fastio  # noqa: E402
from sparsebase_tpu_torch.ops.reorder import RCMReorder  # noqa: E402
from sparsebase_tpu_torch.ops.reorder import rcm as rcm_mod  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture
def saved_config():
    saved = get_config()
    yield
    set_config(**{f: getattr(saved, f) for f in saved.__dataclass_fields__})


def rand_csr(n, m, nnz, seed):
    """(indptr, indices) of a seeded pattern without duplicates, as numpy."""
    r = np.random.default_rng(seed)
    keys = np.unique(r.integers(0, n, nnz).astype(np.int64) * m + r.integers(0, m, nnz))
    csr = ref_sb.COO.new((keys // m).astype(np.int32), (keys % m).astype(np.int32), None, shape=(n, m)).convert(
        ref_sb.CSR)
    return np.asarray(csr.indptr), np.asarray(csr.indices)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_same(port, ref):
    if isinstance(ref, np.ndarray):
        assert isinstance(port, torch.Tensor) and port.device.type == "cpu"
        assert port.numpy().dtype == ref.dtype
        np.testing.assert_array_equal(port.numpy(), ref)
    else:
        assert port == ref


GRAPHS = {"sparse": (150, 150, 600, 0), "denser": (120, 120, 1500, 1), "power": (200, 200, 900, 2)}


def binding_cases():
    """Every graphkit binding case, as a function of (n, indptr, indices)
    that returns the binding's positional arguments."""
    return {
        "slashburn-greedy-hub": lambda n, ip, ix: (n, ip, ix, 8, True, True),
        "slashburn-plain": lambda n, ip, ix: (n, ip, ix, 8, False, False),
        "rcm": lambda n, ip, ix: (n, n, ip, ix),
        "rabbit": lambda n, ip, ix: (n, ip, ix),
        "amd": lambda n, ip, ix: (n, ip, ix, 10.0 * np.sqrt(n), True),
        "amd-plain": lambda n, ip, ix: (n, ip, ix, float("inf"), False),
        "nested_dissection": lambda n, ip, ix: (n, ip, ix, 42, 30, 10, 16),
        "pulp": lambda n, ip, ix: (n, ip, ix, np.random.default_rng(3).choice(n, 4, replace=False), 4,
                                   1.1 * n / 4, 10),
        "pulp-no-seeds": lambda n, ip, ix: (n, ip, ix, np.zeros(0, np.int64), 3, 1.1 * n / 3, 5),
        "jaccard": lambda n, ip, ix: (n, ip, ix, len(ix)),
        "triangles": lambda n, ip, ix: (n, ip, ix, False),
        "triangles-directed": lambda n, ip, ix: (n, ip, ix, True),
        "partition_kway": lambda n, ip, ix: (n, ip, ix, None, 4, 7, 30, 10),
        "partition_kway-weighted": lambda n, ip, ix: (n, ip, ix, np.linspace(1, 3, len(ix)), 3, 7, 30, 10),
        "fill_in": lambda n, ip, ix: (n, ip, ix),
    }


@pytest.mark.parametrize("case", sorted(binding_cases()))
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_graphkit_binding_matches_reference(case, graph):
    assert native.available(), "graphkit did not build"
    n, m, nnz, seed = GRAPHS[graph]
    ip, ix = rand_csr(n, m, nnz, seed)
    args = binding_cases()[case](n, ip, ix)
    fn = case.split("-")[0]
    ref = getattr(ref_native, fn)(*args)
    port_args = [t(a) if isinstance(a, np.ndarray) else a for a in args]
    assert_same(getattr(native, fn)(*port_args), ref)


@pytest.mark.parametrize("shape", [(100, 60), (50, 90)])
def test_graphkit_rcm_rectangular_matches_reference(shape):
    ip, ix = rand_csr(*shape, 4 * max(shape), 9)
    assert_same(native.rcm(*shape, t(ip), t(ix)), ref_native.rcm(*shape, ip, ix))


def test_graphkit_toggle(saved_config):
    set_config(use_graphkit=False)
    assert not native.available()
    set_config(use_graphkit=True)
    assert native.available()


def golden_csr(name):
    coo = ref_sb.io.MTXReader(os.path.join(GOLDEN, f"{name}.mtx")).read_coo()
    csr = coo.convert(ref_sb.CSR)
    return CSR(t(np.asarray(csr.indptr)).to(torch.int64), t(np.asarray(csr.indices)), None, csr.shape)


@pytest.mark.parametrize("golden", ["ash958_sym", "g960"])
@pytest.mark.parametrize("use_graphkit", [True, False])
def test_rcm_host_route_matches_goldens(saved_config, monkeypatch, golden, use_graphkit):
    """Through graphkit (use_graphkit=True) or ``_rcm_host`` (False), the
    order equals the reference library's; each call goes the route the
    toggle names."""
    set_config(use_graphkit=use_graphkit)
    calls = {"native": 0, "host": 0}
    real_native, real_host = native.rcm, rcm_mod._rcm_host

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(native, "rcm", count("native", real_native))
    monkeypatch.setattr(rcm_mod, "_rcm_host", count("host", real_host))
    csr = golden_csr(golden)
    order = RCMReorder().get_reorder(csr)
    assert order.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(), np.loadtxt(os.path.join(GOLDEN, golden, "rcm_order.txt")))
    assert torch.equal(order, real_host(rcm_mod._symmetrized_square(csr)))
    assert calls == ({"native": 1, "host": 0} if use_graphkit else {"native": 0, "host": 1})
    assert torch.equal(ReorderBase.reorder("rcm", csr), order)


@pytest.mark.parametrize("shape", [(120, 120), (100, 60), (50, 90)])
def test_rcm_native_route_equals_host_route(saved_config, shape):
    ip, ix = rand_csr(*shape, 4 * max(shape), 11)
    csr = CSR(t(ip).to(torch.int64), t(ix), None, shape)
    via_native = RCMReorder().get_reorder(csr)
    set_config(use_graphkit=False)
    assert torch.equal(via_native, RCMReorder().get_reorder(csr))


# -- fastio ----------------------------------------------------------------------


def entries_file(tmp_path, weighted):
    rng = np.random.default_rng(4)
    n = 5000
    r, c = rng.integers(1, 10 ** 6, n), rng.integers(1, 10 ** 6, n)
    lines = ["%%MatrixMarket matrix coordinate real general", "% a comment", f"1000000 1000000 {n}"]
    if weighted:
        v = rng.standard_normal(n) * 10.0 ** rng.integers(-8, 8, n)
        body = [f"{a} {b} {x!r}" for a, b, x in zip(r, c, v)]
        body[::97] = [f"{a} {b} {x:.6e}" for a, b, x in zip(r[::97], c[::97], v[::97])]
    else:
        body = [f"{a} {b}" for a, b in zip(r, c)]
    body.insert(2000, "% comment in the body")
    body.insert(3000, "")
    p = tmp_path / "e.mtx"
    p.write_text("\n".join(lines + body) + "\n")
    return str(p), sum(len(x) + 1 for x in lines)


@pytest.mark.parametrize("weighted", [False, True])
def test_fastio_parse_matches_reference(tmp_path, weighted):
    assert fastio.available(), "fastio did not build"
    p, offset = entries_file(tmp_path, weighted)
    assert fastio.count_entries(p, offset) == ref_fastio.count_entries(p, offset)
    got = fastio.parse_entries(p, offset, weighted)
    want = ref_fastio.parse_entries(p, offset, weighted)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert_same(g, w)
    # out= reuses the caller's buffers
    n = len(want[0])
    out = (torch.empty(n + 7, dtype=torch.int64), torch.empty(n + 7, dtype=torch.int64),
           torch.empty(n + 7, dtype=torch.float64))
    again = fastio.parse_entries(p, offset, weighted, out=out)
    assert again[0].data_ptr() == out[0].data_ptr()
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    with pytest.raises(ValueError):
        fastio.parse_entries(p, offset, weighted, out=tuple(o[:10] for o in out))


def test_fastio_parse_values_matches_reference(tmp_path):
    p = tmp_path / "v.txt"
    p.write_text("".join(f"{x!r}\n" for x in np.random.default_rng(2).standard_normal(3000)))
    assert_same(fastio.parse_values(str(p), 0), ref_fastio.parse_values(str(p), 0))


@pytest.mark.parametrize("kind", ["int32", "int64", "wide"])
def test_fastio_sorts_match_reference(kind):
    rng = np.random.default_rng(6)
    n = 70_000
    hi = 2 ** 33 if kind == "wide" else 1000
    dt = np.int32 if kind == "int32" else np.int64
    major, minor = rng.integers(0, hi, n).astype(dt), rng.integers(0, 50, n).astype(dt)
    vals = rng.standard_normal(n)
    assert_same(fastio.argsort_pairs(t(major), t(minor)), ref_fastio.argsort_pairs(major, minor))
    got, want = fastio.sort_pairs_inplace(t(major), t(minor)), ref_fastio.sort_pairs_inplace(major, minor)
    if want is None:  # ids past 2^32 do not pack
        assert got is None
    else:
        for g, w in zip(got, want):
            assert_same(g, w)
    got = fastio.sort_pairs_weighted_inplace(t(major), t(minor), t(vals))
    want = ref_fastio.sort_pairs_weighted_inplace(major, minor, vals)
    if want is None:
        assert got is None
    else:  # ties among equal keys may land in any order: compare by key, then value
        g = np.lexsort((got[2].numpy(), got[1].numpy(), got[0].numpy()))
        w = np.lexsort((want[2], want[1], want[0]))
        for gi, wi in zip(got, want):
            np.testing.assert_array_equal(gi.numpy()[g], wi[w])
    assert fastio.argsort_pairs(t(major.astype(np.int16)), t(minor)) is None


def test_host_build_is_keyed_and_concurrent(tmp_path, monkeypatch):
    """``build_host`` compiles once per source: processes that race on one
    source all load the library that one of them built."""
    import subprocess
    import sys

    src = tmp_path / "tiny.cpp"
    src.write_text('extern "C" int tiny_answer() { return 42; }\n')
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "_build")
    code = ("import ctypes, sys; from pathlib import Path; import sparsebase_tpu_torch._build as b; "
            f"b.BUILD_ROOT = Path({str(tmp_path / '_build')!r}); "
            f"print(ctypes.CDLL(str(b.build_host(Path({str(src)!r})))).tiny_answer())")
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, text=True,
                              cwd=os.path.dirname(os.path.dirname(__file__))) for _ in range(4)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert outs == ["42"] * 4
    libs = list((tmp_path / "_build").glob("*/libtiny.so"))
    assert len(libs) == 1 and not list((tmp_path / "_build").glob("*/*.tmp"))
    assert _build.build_host(src) == libs[0]
    src.write_text('extern "C" int tiny_answer() { return 43; }\n')  # an edited source builds anew
    assert _build.build_host(src) != libs[0]
    src.write_text("this is not C++\n")
    with pytest.raises(_build.KernelBuildError, match="g\\+\\+ exited"):
        _build.build_host(src)


def test_host_libraries_come_from_the_port():
    """The port builds its own copies of the C++ sources, never the JAX
    package's files, into its own build directory."""
    import pathlib

    pkg = pathlib.Path(native.__file__).resolve().parent.parent
    for mod in (native, fastio):
        assert mod._SRC.is_relative_to(pkg) and mod._SRC.exists()
        assert _build.build_host(mod._SRC).is_relative_to(pkg / "_build")
    for path in pkg.rglob("*.py"):
        assert "sparsebase_tpu/io/fastio/lib" not in path.read_text()
        assert "sparsebase_tpu/native/lib" not in path.read_text()


@pytest.mark.parametrize("call", ["rcm", "jaccard", "partition_kway"])
def test_bindings_refuse_tensors_off_the_host(call):
    """A tensor on another device raises instead of being copied to the
    host unseen (a meta tensor stands in for one on the card)."""
    indptr, indices = rand_csr(8, 8, 16, 0)
    ip, ix = t(indptr), t(indices)
    args = {
        "rcm": lambda off: native.rcm(8, 8, off(ip), ix),
        "jaccard": lambda off: native.jaccard(8, ip, off(ix), len(ix)),
        "partition_kway": lambda off: native.partition_kway(8, ip, ix, off(torch.ones(len(ix))), 2, 0, 30, 10),
    }[call]
    with pytest.raises(TypeError, match="CPU tensors"):
        args(lambda a: a.to("meta"))
