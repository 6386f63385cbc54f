"""The hand-written CUDA kernels against their plain versions, on a CUDA
card. Without one these tests skip (the condition is evaluated when each
test runs, not at import).

On the card: ``python -m pytest tests/test_torch_cuda.py -q``. The kernels
are built from ``sparsebase_tpu_torch/csrc`` on first use.

Each kernel is held per row to ``|y_k - y_p| <= 4 * deg_i * eps_f32 *
(|A| |x|)_i``, which bounds two f32 sums of the same terms taken in
different orders.
"""

import pytest
import torch

from sparsebase_tpu_torch import COO, CSR, DIA, _build, preprocess_pipeline, spmv
from sparsebase_tpu_torch.ops.kernels import banded_spmv, csr_spmv, csr_spmv_plain, dia_spmv_plain
from sparsebase_tpu_torch.ops.reorder import DegreeReorder

pytestmark = pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card")

EPS = torch.finfo(torch.float32).eps


@pytest.fixture
def dev():
    return torch.device("cuda", 0)


@pytest.fixture
def gen(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    return g


def assert_rows_within(y, y_ref, deg, absdot):
    torch.cuda.synchronize()
    bound = 4.0 * deg.to(torch.float32) * EPS * absdot
    assert bool(torch.isfinite(y).all())
    assert int(((y - y_ref).abs() > bound).sum()) == 0


@pytest.mark.parametrize("layout", ["strided", "tiled"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(100_003, 100_003), (70_001, 90_000)], ids=["square", "rectangular"])
def test_banded_kernel_matches_plain(dev, gen, shape, dtype, layout):
    n, m = shape
    offsets = torch.tensor([-150, -7, 0, 2, 133], dtype=torch.int32, device=dev)
    dia = DIA(offsets, torch.randn((5, n), generator=gen, device=dev).to(dtype), shape)
    x = torch.randn((m,), generator=gen, device=dev)
    before = _build.launch_counts()["banded_spmv"]
    y = banded_spmv(dia, x, layout=layout)
    assert _build.launch_counts()["banded_spmv"] == before + 1
    absdot = dia_spmv_plain(offsets, dia.data.abs(), x.abs(), shape)
    assert_rows_within(y, dia_spmv_plain(offsets, dia.data, x, shape), torch.full((n,), 5, device=dev), absdot)


@pytest.mark.parametrize("pattern", [False, True], ids=["valued", "pattern"])
def test_csr_kernel_matches_plain(dev, gen, pattern):
    deg = torch.randint(0, 40, (20_000,), generator=gen, device=dev)
    deg[::7] = 0
    deg[123] = 262_144
    indptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), deg.cumsum(0)])
    nnz = int(indptr[-1])
    cols = torch.randint(0, 30_000, (nnz,), generator=gen, device=dev, dtype=torch.int32)
    vals = None if pattern else torch.randn((nnz,), generator=gen, device=dev)
    csr = CSR(indptr, cols, vals, (20_000, 30_000)).sort_rows()
    x = torch.randn((30_000,), generator=gen, device=dev)
    before = _build.launch_counts()["csr_spmv"]
    y = csr_spmv(csr, x)
    assert _build.launch_counts()["csr_spmv"] == before + 1
    abs_csr = CSR(indptr, csr.indices, None if pattern else csr.vals.abs(), csr.shape)
    assert_rows_within(y, csr_spmv_plain(csr, x), deg, csr_spmv_plain(abs_csr, x.abs()))


def test_pipeline_on_card_matches_cpu(dev, gen):
    n, nnz = 20_000, 300_000
    row = torch.randint(0, n, (nnz,), generator=gen, device=dev, dtype=torch.int32)
    col = torch.randint(0, n, (nnz,), generator=gen, device=dev, dtype=torch.int32)
    coo = COO.new(row, col, torch.randn((nnz,), generator=gen, device=dev), (n, n))
    x = torch.randn((n,), generator=gen, device=dev)
    before = _build.launch_counts()["csr_spmv"]
    permuted, y = preprocess_pipeline(coo, x)
    assert _build.launch_counts()["csr_spmv"] == before + 1
    cpu_permuted, cpu_y = preprocess_pipeline(coo.to_host(), x.cpu())
    assert torch.equal(permuted.indptr.cpu(), cpu_permuted.indptr)
    assert torch.equal(permuted.indices.cpu(), cpu_permuted.indices)
    assert torch.equal(permuted.vals.cpu(), cpu_permuted.vals)
    ro = DegreeReorder().get_reorder(coo.convert(CSR))
    assert torch.equal(ro.cpu(), DegreeReorder().get_reorder(coo.to_host().convert(CSR)))
    torch.testing.assert_close(y.cpu(), cpu_y, rtol=1e-5, atol=1e-5)


def test_path_b_on_card(dev, gen):
    n = 50_000
    i = torch.arange(n, device=dev)[:, None]
    j = i + torch.arange(-16, 17, device=dev)[None, :]
    ok = (j >= 0) & (j < n)
    row, col = i.expand_as(j)[ok].to(torch.int32), j[ok].to(torch.int32)
    coo = COO(row, col, torch.randn((row.numel(),), generator=gen, device=dev), (n, n))
    x = torch.randn((n,), generator=gen, device=dev)
    csr = coo.convert(CSR)
    dia = csr.convert(DIA)
    assert dia.num_diagonals == 33
    before = _build.launch_counts()["banded_spmv"]
    y = spmv(dia, x)
    assert _build.launch_counts()["banded_spmv"] == before + 1
    absdot = dia_spmv_plain(dia.offsets, dia.data.abs(), x.abs(), dia.shape)
    assert_rows_within(y, spmv(csr, x), csr.degrees(), absdot)
