"""Port parity for the modules that hold kernels, on the CPU.

The wrappers of K1 (DIA SpMV) and K2 (CSR SpMV) take their plain versions
for CPU tensors; those are held against the JAX package on the same numpy
inputs: the Pallas kernel in interpret mode (as tests/test_dia.py runs it),
the XLA roll formulation, the pure-jnp oracle, and the segment-sum CSR
SpMV. The CUDA kernels themselves run in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import sparsebase_tpu as ref  # noqa: E402
from sparsebase_tpu.convert.kernels import csr_to_dia as ref_csr_to_dia  # noqa: E402
from sparsebase_tpu.models.pipelines import spmv_csr as ref_spmv_csr  # noqa: E402
from sparsebase_tpu.ops.kernels import (  # noqa: E402
    banded_spmv as ref_banded_spmv,
    banded_spmv_pallas,
    dia_spmv_reference,
)

from sparsebase_tpu_torch import _build  # noqa: E402
from sparsebase_tpu_torch.interop import from_reference  # noqa: E402
from sparsebase_tpu_torch.ops.kernels import (  # noqa: E402
    banded_spmv,
    csr_spmv,
    tile_band,
    untile_band,
)
from sparsebase_tpu_torch.utils.exceptions import TypeMismatchError  # noqa: E402

CPU = torch.device("cpu")


def band_csr(seed, n, m, offsets):
    """Reference CSR with every in-range entry of the given diagonals."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for off in offsets:
        i = np.arange(n)
        ok = (i + off >= 0) & (i + off < m)
        rows.append(i[ok])
        cols.append(i[ok] + off)
    row = np.concatenate(rows).astype(np.int32)
    col = np.concatenate(cols).astype(np.int32)
    vals = rng.standard_normal(row.size).astype(np.float32)
    return ref.COO.new(row, col, vals, (n, m)).convert(ref.CSR)


WIDE = (-150, -7, 0, 2, 133)
# name -> (reference CSR, band dtype, port layout, tile width)
DIA_CASES = {
    "tridiag": (lambda: band_csr(0, 100, 100, (-1, 0, 1)), "f32", "strided", None),
    "n257": (lambda: band_csr(1, 257, 257, (-1, 0, 1)), "f32", "strided", None),
    "wide-band": (lambda: band_csr(2, 640, 640, WIDE), "f32", "strided", None),
    "rectangular": (lambda: band_csr(3, 300, 520, (-4, 0, 9, 260)), "f32", "strided", None),
    "bf16-band": (lambda: band_csr(4, 513, 513, (-1, 0, 1)), "bf16", "strided", None),
    "tiled": (lambda: band_csr(5, 700, 700, WIDE), "f32", "tiled", 128),
}
REFERENCES = {
    "pallas": lambda dia, x, tile: banded_spmv_pallas(
        dia, x, interpret=True, **({"tiled": True, "block": tile} if tile else {})
    ),
    "xla-roll": lambda dia, x, tile: ref_banded_spmv(dia, x),
    "jnp-oracle": lambda dia, x, tile: dia_spmv_reference(dia, x),
}


@pytest.mark.parametrize("reference", sorted(REFERENCES))
@pytest.mark.parametrize("case", sorted(DIA_CASES))
def test_banded_spmv_matches_reference(case, reference):
    make, dtype, layout, tile = DIA_CASES[case]
    ref_dia = ref_csr_to_dia(make())
    if dtype == "bf16":
        ref_dia = ref_dia.astype(jnp.bfloat16)
    n, m = ref_dia.shape
    x = np.random.default_rng(7).standard_normal(m).astype(np.float32)
    want = np.asarray(REFERENCES[reference](ref_dia, x, tile))
    dia = from_reference(ref_dia, CPU)
    launches = _build.launch_counts()["banded_spmv"]
    kwargs = {"layout": layout} if tile is None else {"layout": layout, "block": tile}
    got = banded_spmv(dia, torch.from_numpy(x), **kwargs)
    assert _build.launch_counts()["banded_spmv"] == launches  # CPU: plain version, no launch
    assert got.dtype == torch.float32 and got.shape == (n,)
    if dtype == "bf16":
        # bf16 keeps 8 mantissa bits: the error scales with the result
        atol = 2e-2 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=atol)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,block", [(700, 128), (128, 128), (5, 4096)])
def test_tile_band_round_trip(n, block):
    data = torch.randn((3, n))
    tiles = tile_band(data, block)
    assert tiles.shape == (-(-n // block), 3, block)
    assert torch.equal(untile_band(tiles, n), data)
    assert int((tiles.reshape(-1) != 0).sum()) == int((data != 0).sum())


def csr_with(seed, degrees, ncols, pattern=False):
    rng = np.random.default_rng(seed)
    indptr = np.concatenate([[0], np.cumsum(degrees)]).astype(np.int64)
    nnz = int(indptr[-1])
    indices = rng.integers(0, ncols, nnz).astype(np.int32)
    vals = None if pattern else rng.standard_normal(nnz).astype(np.float32)
    return ref.CSR.new(indptr, indices, vals, (len(degrees), ncols))


def _degrees(seed, n, hi):
    d = np.random.default_rng(seed).integers(0, hi, n)
    d[::5] = 0  # empty rows
    return d


CSR_CASES = {
    "empty-rows": lambda: csr_with(0, _degrees(10, 400, 30), 500),
    "pattern": lambda: csr_with(1, _degrees(11, 400, 30), 500, pattern=True),
    "dense-row": lambda: csr_with(2, np.r_[_degrees(12, 300, 10), 2000], 800),
    "all-empty": lambda: csr_with(3, np.zeros(50, np.int64), 20),
}


@pytest.mark.parametrize("case", sorted(CSR_CASES))
def test_csr_spmv_matches_segment_sum(case):
    ref_csr = CSR_CASES[case]()
    x = np.random.default_rng(8).standard_normal(ref_csr.ncols).astype(np.float32)
    want = np.asarray(ref_spmv_csr(ref_csr, x, method="segment"))
    got = csr_spmv(from_reference(ref_csr, CPU), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_wrappers_never_fall_back_off_cpu():
    """A tensor that is not on the CPU never takes the plain version: on a
    device without a kernel the wrapper raises."""
    csr = from_reference(CSR_CASES["empty-rows"](), CPU)
    dia = from_reference(ref_csr_to_dia(DIA_CASES["tridiag"][0]()), CPU)
    meta = torch.device("meta")
    with pytest.raises(TypeMismatchError):
        csr_spmv(csr.to_device(meta), torch.empty(csr.ncols, device=meta))
    with pytest.raises(TypeMismatchError):
        csr_spmv(csr, torch.empty(csr.ncols, device=meta))
    with pytest.raises(TypeMismatchError):
        banded_spmv(dia.to_device(meta), torch.empty(dia.shape[1], device=meta))
    with pytest.raises(ValueError):
        banded_spmv(dia, torch.zeros(3))
    with pytest.raises(ValueError):
        banded_spmv(dia, torch.zeros(dia.shape[1]), layout="diagonal")


def test_build_is_keyed_on_sources_and_fails_loudly(tmp_path, monkeypatch):
    cmd = _build.nvcc_command("nvcc", tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert [c for c in cmd if c.endswith(".cu")] == [str(_build.CSRC / s) for s in _build.SOURCES]
    key = _build.source_hash()
    for name in _build.SOURCES:
        (tmp_path / name).write_text((_build.CSRC / name).read_text())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.source_hash() == key
    (tmp_path / _build.SOURCES[0]).write_text("// edited\n")
    assert _build.source_hash() != key
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(tmp_path / "no-such-nvcc"))
    with pytest.raises(FileNotFoundError):
        _build.build()
    monkeypatch.setattr(_build, "find_nvcc", lambda: "false")  # a compiler that always fails
    with pytest.raises(_build.KernelBuildError):
        _build.build()
