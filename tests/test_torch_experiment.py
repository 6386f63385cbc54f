"""Port parity for the experiment harness (``experiment.py``), on the CPU.

The same files and the same numpy kernels go through the JAX harness and the
port's (loaders with ``device="cpu"``): the run-time keys and their order,
the results (exactly) and the auxiliary formats (every array equal) must be
the same. ``reorder_csr`` must give the JAX package's matrix exactly, square
and rectangular. The port's ``_sync`` has no ``try``: a failure at the
synchronise, or in a kernel, leaves ``run()``. The test files are a tmp MTX
and ``tests/golden/g960.mtx``.
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import sparsebase_tpu.experiment as ref_exp  # noqa: E402
import sparsebase_tpu.ops.reorder as ref_reorder  # noqa: E402
from sparsebase_tpu.formats.coo import COO as RefCOO  # noqa: E402
from sparsebase_tpu.formats.csc import CSC as RefCSC  # noqa: E402
from sparsebase_tpu.formats.csr import CSR as RefCSR  # noqa: E402

import fixture as fx  # noqa: E402
import sparsebase_tpu_torch.experiment as exp  # noqa: E402
import sparsebase_tpu_torch.ops.reorder as reorder  # noqa: E402
from sparsebase_tpu_torch import COO, CSC, CSR, IOBase  # noqa: E402
from sparsebase_tpu_torch.interop import to_numpy  # noqa: E402

GOLDEN = Path(__file__).resolve().parent / "golden"
G960 = str(GOLDEN / "g960.mtx")

MTX = """%%MatrixMarket matrix coordinate integer general
3 3 4
1 2 1
1 3 2
2 1 3
3 1 4
"""


@pytest.fixture
def mtx_file(tmp_path):
    p = tmp_path / "m.mtx"
    p.write_text(MTX)
    return str(p)


def rect_mtx(tmp_path, n=37, m=61, nnz=300, seed=3):
    """A rectangular real MTX file from a seed (duplicates merged by the
    unique keys, values from a normal draw)."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, n, nnz) * m + rng.integers(0, m, nnz))
    vals = rng.standard_normal(len(keys))
    lines = [f"{k // m + 1} {k % m + 1} {float(v)!r}" for k, v in zip(keys, vals)]
    p = tmp_path / "rect.mtx"
    p.write_text(f"%%MatrixMarket matrix coordinate real general\n{n} {m} {len(keys)}\n" + "\n".join(lines) + "\n")
    return str(p)


# -- numpy kernels: the same function of either package's format ---------------
def spmv_kernel(data, fparams, pparams, kparams):
    x = np.ones(data.ncols, np.float64)
    vals = np.asarray(data.vals, dtype=np.float64)
    out = np.zeros(data.nrows)
    np.add.at(out, np.asarray(data.row_of_nnz()), vals * x[np.asarray(data.indices)])
    return out


def nnz_kernel(data, fparams, pparams, kparams):
    return data.nnz


def arrays_kernel(data, fparams, pparams, kparams):
    """Every array of the format (by field name, as int64 or float64) and
    the shape; ``kparams`` is appended, so that the params reach the kernel."""
    fields = ("row", "col", "indptr", "indices", "vals")
    out = {f: np.asarray(getattr(data, f)).astype(np.float64 if f == "vals" else np.int64)
           for f in fields if getattr(data, f, None) is not None}
    return out, tuple(int(s) for s in data.shape), kparams


def assert_results_equal(got, want):
    assert type(got) is type(want)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_results_equal(g, w)
    elif isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            assert_results_equal(got[k], want[k])
    else:
        assert got == want


def assert_formats_equal(port_fmt, ref_fmt):
    """The same format class, shape and arrays (values with their dtype)."""
    assert type(port_fmt).__name__ == type(ref_fmt).__name__
    got = to_numpy(port_fmt)
    assert tuple(got.pop("shape")) == tuple(int(s) for s in ref_fmt.shape)
    for name, arr in got.items():
        want = getattr(ref_fmt, name)
        if arr is None or want is None:
            assert arr is None and want is None, name
            continue
        want = np.asarray(want)
        if name == "vals":
            assert arr.dtype == want.dtype, name
        np.testing.assert_array_equal(arr, want, err_msg=name)


LOADERS = {  # name: (port loader, JAX loader)
    "csr": (functools.partial(exp.load_csr, device="cpu"), ref_exp.load_csr),
    "coo": (functools.partial(exp.load_coo, device="cpu"), ref_exp.load_coo),
    "csc": (functools.partial(exp.load_csc, device="cpu"), ref_exp.load_csc),
    "format-coo": (exp.load_format(COO, device="cpu"), ref_exp.load_format(RefCOO)),
    "format-csc": (exp.load_format(CSC, device="cpu"), ref_exp.load_format(RefCSC)),
}


def both_runs(loader, targets, preprocesses, kernels, warmup, times, store_auxiliary):
    """The same experiment through both harnesses: ``(port, reference)``.
    ``preprocesses`` and ``kernels`` hold (id, port fn, JAX fn, params)."""
    out = []
    for side, module in ((0, exp), (1, ref_exp)):
        e = module.ConcreteExperiment(warmup=warmup)
        e.add_data_loader(LOADERS[loader][side], targets)
        for pid, *fns, params in preprocesses:
            e.add_preprocess(pid, fns[side], params)
        for kid, *fns, params in kernels:
            e.add_kernel(kid, fns[side], params)
        out.append(e.run(times=times, store_auxiliary=store_auxiliary))
    return out


@pytest.mark.parametrize("warmup", [0, 2])
@pytest.mark.parametrize("loader", sorted(LOADERS))
def test_experiment_equals_reference(mtx_file, loader, warmup):
    """Two targets (a tmp MTX with its file params, then g960), two
    preprocesses, three kernels (one with params), two reps, auxiliary data
    stored: keys in the same order, results exactly, auxiliary formats
    array for array."""
    targets = [([mtx_file], {"f": 1}), ([G960], None)]
    preprocesses = [("pass", exp.pass_preprocess, ref_exp.pass_preprocess, None)]
    kernels = [("arrays", arrays_kernel, arrays_kernel, {"k": 2}), ("nnz", nnz_kernel, nnz_kernel, None)]
    if loader == "csr":
        preprocesses.append(("degree", exp.reorder_csr(reorder.DegreeReorder),
                             ref_exp.reorder_csr(ref_reorder.DegreeReorder), {"p": 3}))
        kernels.insert(0, ("spmv", spmv_kernel, spmv_kernel, None))
    port, ref = both_runs(loader, targets, preprocesses, kernels, warmup, times=2, store_auxiliary=True)
    keys = list(ref.get_run_times())
    assert len(keys) == 2 * len(preprocesses) * len(kernels) * 2
    assert list(port.get_run_times()) == keys
    assert all(t >= 0 for t in port.get_run_times().values())
    assert list(port.get_results()) == keys
    for key in keys:
        assert_results_equal(port.get_results()[key], ref.get_results()[key])
    aux, ref_aux = port.get_auxiliary(), ref.get_auxiliary()
    assert list(aux) == list(ref_aux)
    for key in ref_aux:
        assert_formats_equal(aux[key], ref_aux[key])


def test_experiment_without_auxiliary_and_one_rep(mtx_file, tmp_path):
    """The reference tests' cartesian product: 1 loader × 2 files × 1
    preprocess × 2 kernels × 1 rep, no auxiliary data."""
    p2 = tmp_path / "m2.mtx"
    p2.write_text(MTX)
    targets = [([mtx_file], None), ([str(p2)], None)]
    kernels = [("spmv", spmv_kernel, spmv_kernel, None), ("nnz", nnz_kernel, nnz_kernel, None)]
    port, ref = both_runs("csr", targets, [("pass", exp.pass_preprocess, ref_exp.pass_preprocess, None)], kernels,
                          warmup=1, times=1, store_auxiliary=False)
    assert list(port.get_run_times()) == list(ref.get_run_times())
    assert len(port.get_run_times()) == 4 and port.get_auxiliary() == {}
    res = port.get_results()
    np.testing.assert_array_equal(res[f"{mtx_file},pass,spmv,0"], fx.DENSE.sum(axis=1))
    assert res[f"{p2},pass,nnz,0"] == 4


# RCM orders square matrices only, in both packages
@pytest.mark.parametrize("shape,name", [("square", "degree"), ("square", "gray"), ("square", "rcm"),
                                        ("rectangular", "degree"), ("rectangular", "gray")])
def test_reorder_csr_equals_reference(tmp_path, name, shape):
    """``reorder_csr`` gives the JAX package's matrix exactly: g960 through
    ``permute2d``, a rectangular matrix through ``permute2d_rowwise``."""
    path = G960 if shape == "square" else rect_mtx(tmp_path)
    cls = {"degree": "DegreeReorder", "gray": "GrayReorder", "rcm": "RCMReorder"}[name]
    port_csr = exp.load_csr([path], device="cpu")
    ref_csr = ref_exp.load_csr([path])
    got = exp.reorder_csr(getattr(reorder, cls))(port_csr, None, None)
    want = ref_exp.reorder_csr(getattr(ref_reorder, cls))(ref_csr, None, None)
    assert isinstance(got, CSR) and isinstance(want, RefCSR)
    assert_formats_equal(got, want)
    assert got.shape == port_csr.shape


def test_loaders_read_onto_the_card_by_default(mtx_file):
    """Without ``device=`` each loader reads onto CUDA; with no card it
    raises instead of reading onto the CPU."""
    loaders = [exp.load_csr, exp.load_coo, exp.load_csc, exp.load_format(COO)]
    for load in loaders:
        if torch.cuda.is_available():
            out = load([mtx_file])
            assert out._tensors()[0].device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                load([mtx_file])


def test_sync_walks_formats_and_containers():
    a, b, c = torch.zeros(2), torch.ones(3), torch.arange(4)
    csr = CSR(torch.tensor([0, 1]), torch.tensor([0], dtype=torch.int32), None, (1, 1))
    found = list(exp._tensors_of({"x": [a, (b, {"y": c})], "f": csr, "n": 3, "s": "t"}))
    assert [id(t) for t in found] == [id(a), id(b), id(c), *map(id, csr._tensors())]
    obj = ([a], {"k": csr})
    assert exp._sync(obj) is obj


def test_sync_waits_for_the_current_device_once_cuda_is_initialised(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    for initialised, want in ((False, []), (True, [None])):
        calls.clear()
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: initialised)
        exp._sync(torch.zeros(3))
        assert calls == want


def _failing(*args, **kwargs):
    raise RuntimeError("CUDA error: an illegal memory access was encountered")


def test_run_raises_when_the_synchronise_fails(mtx_file, monkeypatch):
    """An error raised at the synchronise (as an asynchronous CUDA error is)
    leaves ``run()``; it is not timed as a fast run."""
    monkeypatch.setattr(torch.cuda, "is_initialized", _failing)
    monkeypatch.setattr(torch.cuda, "synchronize", _failing)
    e = exp.ConcreteExperiment(warmup=0)
    e.add_data_loader(functools.partial(exp.load_csr, device="cpu"), [([mtx_file], None)])
    e.add_preprocess("pass", exp.pass_preprocess)
    e.add_kernel("degrees", lambda d, f, p, k: d.degrees())
    with pytest.raises(RuntimeError, match="illegal memory access"):
        e.run()
    assert e.get_run_times() == {}


@pytest.mark.parametrize("warmup", [0, 1])
def test_run_raises_when_a_kernel_raises(mtx_file, warmup):
    e = exp.ConcreteExperiment(warmup=warmup)
    e.add_data_loader(functools.partial(exp.load_csr, device="cpu"), [([mtx_file], None)])
    e.add_preprocess("pass", exp.pass_preprocess)
    e.add_kernel("bad", _failing)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        e.run(times=2)
    assert e.get_run_times() == {}


def test_trace_dir_writes_a_trace_naming_its_scope(mtx_file, tmp_path):
    """One traced run: ``trace_dir/<pid>-<kid>-<i>/trace.json`` holds the
    run's ``record_function`` scope and the dispatch layer's op span."""
    e = exp.ConcreteExperiment(warmup=0, trace_dir=str(tmp_path / "traces"))
    e.add_data_loader(functools.partial(exp.load_csr, device="cpu"), [([mtx_file], None)])
    e.add_preprocess("pass", exp.pass_preprocess)
    e.add_kernel("degree", lambda d, f, p, k: reorder.DegreeReorder().get_reorder(d))
    e.run(times=1)
    trace = tmp_path / "traces" / "pass-degree-0" / "trace.json"
    names = {ev.get("name") for ev in json.loads(trace.read_text())["traceEvents"]}
    assert "pass-degree-0" in names
    assert any(str(n).startswith("sbtorch:op:") for n in names)
    torch.testing.assert_close(e.get_results()[f"{mtx_file},pass,degree,0"],
                               reorder.DegreeReorder().get_reorder(IOBase.read_mtx_to_csr(mtx_file, device="cpu")))


# -- the distributed helpers (load_sharded_csr, distributed_reorder, distributed_spmv_kernel)
ASH958_SYM = str(GOLDEN / "ash958_sym.mtx")


@pytest.mark.parametrize("d", [4, 8])
def test_sharded_loader_pipeline(d):
    """The JAX suite's distributed experiment on a CPU mesh: the recorded SpMV
    is ``halo.spmv`` of ones and the order ``halo.rcm_reorder``, as the JAX
    helpers compute them."""
    import jax.numpy as jnp
    from sparsebase_tpu.parallel import ShardedCSR as RefShardedCSR
    from sparsebase_tpu.parallel import halo as ref_halo
    from sparsebase_tpu.parallel import make_mesh as ref_make_mesh

    from sparsebase_tpu_torch.parallel import ShardedCSR, halo, make_mesh

    mesh = make_mesh(devices=["cpu"] * d)
    ex = exp.ConcreteExperiment(warmup=0)
    ex.add_data_loader(exp.load_sharded_csr(mesh), [((ASH958_SYM,), None)])
    ex.add_preprocess("pass", exp.pass_preprocess)
    ex.add_preprocess("rcm", exp.distributed_reorder("rcm"))
    ex.add_kernel("spmv", exp.distributed_spmv_kernel)
    ex.run(times=1, store_auxiliary=True)
    times = ex.get_run_times()
    assert list(times) == [f"{ASH958_SYM},{pid},spmv,0" for pid in ("pass", "rcm")]
    assert all(t > 0 for t in times.values())
    sh, got_mesh = ex.get_auxiliary()[f"data,{ASH958_SYM}"]
    assert isinstance(sh, ShardedCSR) and sh.has_halo and got_mesh is mesh and sh.devices == mesh.axis_devices("x")
    csr = IOBase.read_mtx_to_csr(ASH958_SYM, device="cpu")
    ones = torch.ones(csr.ncols)
    want_y = halo.spmv(ShardedCSR.from_csr(csr, mesh), ones, mesh)
    for pid in ("pass", "rcm"):
        y = ex.get_results()[f"{ASH958_SYM},{pid},spmv,0"]
        assert torch.equal(y, want_y)
    _, _, order = ex.get_auxiliary()[f"preprocess,rcm,{ASH958_SYM}"]
    assert torch.equal(order, halo.rcm_reorder(sh, mesh))
    fx.check_reorder(order.numpy(), csr.nrows)
    # the same helpers of the JAX package give the same SpMV and order
    rmesh = ref_make_mesh(d)
    ref_sh = RefShardedCSR.from_csr(RefCSR(*(np.asarray(a) for a in (csr.indptr, csr.indices)), None, csr.shape), rmesh)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_halo.spmv(ref_sh, jnp.ones(csr.ncols), rmesh)), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(order.numpy(), np.asarray(ref_halo.rcm_reorder(ref_sh, rmesh)))


def test_distributed_degree_reorder_and_unknown_kind():
    from sparsebase_tpu_torch.parallel import dist, make_mesh

    mesh = make_mesh(devices=["cpu"] * 4)
    data = exp.load_sharded_csr(mesh)([G960])
    sh, m, order = exp.distributed_reorder("degree")(data, None, None)
    assert sh is data[0] and m is mesh
    assert torch.equal(order, dist.degree_reorder(sh, mesh))
    with pytest.raises(ValueError, match="unknown distributed reorder"):
        exp.distributed_reorder("gray")(data, None, None)


def test_sharded_loader_without_a_mesh_takes_the_cards(monkeypatch):
    """``mesh=None`` is ``make_mesh()`` over the visible cards: with none it
    raises instead of sharding on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        exp.load_sharded_csr()([G960])
