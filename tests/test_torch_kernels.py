"""Port parity for the modules that hold kernels, on the CPU.

The wrappers of K1 (DIA SpMV), K2 (CSR SpMV), K3 (indptr), K4 (CSR
relocation) and K5 (stable radix sort) take their plain versions for CPU
tensors; those are held against the JAX package on the same numpy inputs:
the Pallas kernel in interpret mode (as tests/test_dia.py runs it), the XLA
roll formulation, the pure-jnp oracle, the segment-sum CSR SpMV, and for
K3-K5 the JAX functions that do the same step.

K3-K5 replace the Pallas kernels of ``tools/pallas_attempts.py``
(``build_stream_indptr``, ``build_vector_gather``, ``build_radix_scalar``,
``build_radix_matmul``). Those are nested inside that tool's ``main()`` and
cannot be imported, so each port is held against the JAX package's function
for its step instead: ``indptr_from_sorted_rows`` (and ``_blocked``),
``ranks_from_sort_keys``, and ``permute_2d`` / ``CSR.new``. The CUDA
kernels themselves run in tests/test_torch_cuda.py.
"""

import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import sparsebase_tpu as ref  # noqa: E402
from sparsebase_tpu.convert.kernels import csr_to_dia as ref_csr_to_dia  # noqa: E402
from sparsebase_tpu.convert.kernels import indptr_from_sorted_rows as ref_indptr  # noqa: E402
from sparsebase_tpu.convert.kernels import indptr_from_sorted_rows_blocked as ref_indptr_blocked  # noqa: E402
from sparsebase_tpu.models.pipelines import spmv_csr as ref_spmv_csr  # noqa: E402
from sparsebase_tpu.ops.kernels import (  # noqa: E402
    banded_spmv as ref_banded_spmv,
    banded_spmv_pallas,
    dia_spmv_reference,
)
from sparsebase_tpu.ops.permute import permute_2d as ref_permute_2d  # noqa: E402
from sparsebase_tpu.ops.reorder import DegreeReorder as RefDegreeReorder  # noqa: E402
from sparsebase_tpu.ops.reorder.base import ranks_from_sort_keys as ref_ranks  # noqa: E402

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from sparsebase_tpu_torch import COO, CSR, _build  # noqa: E402
from sparsebase_tpu_torch.convert.kernels import (  # noqa: E402
    indptr_from_sorted_rows,
    sort_by_pairs,
    sort_by_pairs_plain,
)
from sparsebase_tpu_torch.interop import from_reference, to_numpy  # noqa: E402
from sparsebase_tpu_torch.ops.kernels import (  # noqa: E402
    banded_spmv,
    csr_spmv,
    indptr_plain,
    plan_passes,
    radix_argsort,
    radix_argsort_plain,
    radix_passes_plain,
    radix_rank,
    radix_rank_plain,
    relocate_csr,
    tile_band,
    untile_band,
)
from sparsebase_tpu_torch.ops.kernels import radix as radix_module  # noqa: E402
from sparsebase_tpu_torch.ops.kernels._args import kernel_ids, kernel_offsets  # noqa: E402
from sparsebase_tpu_torch.ops.kernels.csr_spmv import TILE, tile_count  # noqa: E402
from sparsebase_tpu_torch.ops.kernels.radix import bits_below, scratch_bytes  # noqa: E402
from sparsebase_tpu_torch.ops.kernels.relocate import BLOCK_MAX, WARP_MAX, long_row_capacity  # noqa: E402
from sparsebase_tpu_torch.ops.permute import permute_2d  # noqa: E402
from sparsebase_tpu_torch.ops.reorder import DegreeReorder, ranks_from_sort_keys  # noqa: E402
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


def sorted_rows(seed, nrows, nnz, live):
    """``nnz`` row ids drawn from the ``live`` rows, sorted (int32)."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(np.asarray(live), nnz)).astype(np.int32)


_GAP = 1_000_000
# name -> (row ids, nrows)
INDPTR_CASES = {
    "leading-empty": lambda: (sorted_rows(20, 60, 400, range(7, 60)), 60),
    "trailing-empty": lambda: (sorted_rows(21, 60, 400, range(0, 45)), 60),
    "interior-empty": lambda: (sorted_rows(22, 90, 500, [r for r in range(90) if r % 3 and not 40 <= r < 55]), 90),
    "no-entries": lambda: (np.zeros((0,), np.int32), 25),
    "gap-of-1M-rows": lambda: (np.r_[sorted_rows(23, 3, 30, range(3)), np.full(40, _GAP + 3, np.int32)], _GAP + 9),
}
INDPTR_REFERENCES = {
    "global-sort": lambda row, nrows: ref_indptr(jnp.asarray(row), nrows, row.size),
    "blocked": lambda row, nrows: ref_indptr_blocked(jnp.asarray(row), nrows, row.size, block=16),
}


@pytest.mark.parametrize("reference", sorted(INDPTR_REFERENCES))
@pytest.mark.parametrize("case", sorted(INDPTR_CASES))
def test_indptr_matches_reference(case, reference):
    """K3's plain version against the JAX boundary-sort and blocked indptr
    functions (JAX on the CPU), exactly."""
    row, nrows = INDPTR_CASES[case]()
    want = np.asarray(INDPTR_REFERENCES[reference](row, nrows))
    launches = _build.launch_counts()["indptr"]
    got = indptr_from_sorted_rows(torch.from_numpy(row), nrows)
    assert _build.launch_counts()["indptr"] == launches  # CPU: plain version, no launch
    assert got.dtype == torch.int64 and got.shape == (nrows + 1,)
    np.testing.assert_array_equal(got.numpy(), want)


# name -> integer keys (int32: the JAX package runs without x64)
RANK_CASES = {
    "ascending": lambda rng: rng.integers(0, 40, 700),
    "descending": lambda rng: -rng.integers(0, 40, 700),
    "all-equal": lambda rng: np.full(300, 7),
    "three-digit-passes": lambda rng: rng.choice(rng.integers(1 << 16, 1 << 24, 200), 3000),
    "signed": lambda rng: rng.integers(-5000, 5000, 1500),
}


@pytest.mark.parametrize("case", sorted(RANK_CASES))
def test_radix_rank_matches_reference(case):
    """K5's plain versions against the JAX ``ranks_from_sort_keys`` (JAX on
    the CPU) and numpy's stable argsort, exactly: equal keys keep their
    input order."""
    keys = RANK_CASES[case](np.random.default_rng(30)).astype(np.int32)
    want_rank = np.asarray(ref_ranks(jnp, jnp.asarray(keys)))
    launches = _build.launch_counts()["radix_rank"]
    got = ranks_from_sort_keys(torch.from_numpy(keys))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want_rank)
    np.testing.assert_array_equal(radix_rank(torch.from_numpy(keys)).numpy(), want_rank)
    perm = radix_argsort(torch.from_numpy(keys))
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), np.argsort(keys, kind="stable"))
    assert _build.launch_counts()["radix_rank"] == launches


def coo_graph(seed, n, m, nnz, long_row=None, pattern=False, dtype=np.float32):
    """Row-major-sorted triplets with 20 copies of one coordinate and
    optionally one row of ``long_row`` entries (duplicates likely)."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n, nnz)
    col = rng.integers(0, m, nnz)
    row[:20], col[:20] = row[0], col[0]
    if long_row is not None:
        row = np.r_[row, np.full(long_row, n // 2)]
        col = np.r_[col, rng.integers(0, m, long_row)]
    order = np.lexsort((col, row))
    row, col = row[order].astype(np.int32), col[order].astype(np.int32)
    vals = None if pattern else rng.standard_normal(row.size).astype(dtype)
    return row, col, vals


# name -> (graph kwargs, which orders: rows / cols)
RELOCATE_CASES = {
    "rows-only": (dict(n=300, m=300, nnz=3000), True, False),
    "cols-only": (dict(n=300, m=300, nnz=3000), False, True),
    "both-nonsymmetric": (dict(n=300, m=300, nnz=3000), True, True),
    "sort-only": (dict(n=300, m=300, nnz=3000), False, False),
    "rectangular": (dict(n=200, m=450, nnz=2500), True, True),
    "pattern": (dict(n=300, m=300, nnz=3000, pattern=True), True, True),
    "float64-values": (dict(n=300, m=300, nnz=3000, dtype=np.float64), True, True),
    "row-of-5000": (dict(n=400, m=700, nnz=2000, long_row=5000), True, True),
}


@pytest.mark.parametrize("case", sorted(RELOCATE_CASES))
def test_relocate_matches_permute_2d(case):
    """K4's plain version (and ``permute_2d`` through it) against the JAX
    ``permute_2d`` on host arrays, whose pair sort is stable: ``indptr``,
    ``indices`` and ``vals`` equal exactly, duplicate coordinates included."""
    kwargs, rows, cols = RELOCATE_CASES[case]
    n, m = kwargs["n"], kwargs["m"]
    row, col, vals = coo_graph(40, **kwargs)
    rng = np.random.default_rng(41)
    ro = rng.permutation(n).astype(np.int32) if rows else None
    co = rng.permutation(m).astype(np.int32) if cols else None
    ref_csr = ref.COO.new(row, col, vals, (n, m)).convert(ref.CSR)
    want = ref_permute_2d(ref_csr, ro, co)
    csr = from_reference(ref_csr, CPU)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    launches = _build.launch_counts()["relocate_csr"]
    for got in (relocate_csr(csr, t(ro), t(co)), permute_2d(csr, t(ro), t(co))):
        assert isinstance(got, CSR) and got.shape == (n, m)
        got_np = to_numpy(got)
        for key in ("indptr", "indices", "vals"):
            w = getattr(want, key)
            if w is None:
                assert got_np[key] is None
            else:
                np.testing.assert_array_equal(got_np[key], np.asarray(w), err_msg=key)
    assert _build.launch_counts()["relocate_csr"] == launches


# name -> row degrees; K4 lists the rows of WARP_MAX + 1 to BLOCK_MAX entries,
# and those over BLOCK_MAX, on the device, into slots sized from n and nnz
LONG_ROW_CASES = {
    "path-a-like": lambda rng: rng.poisson(16, 20_000),
    "all-33": lambda rng: np.full(3_000, WARP_MAX + 1),
    "all-over-cap": lambda rng: np.full(40, BLOCK_MAX + 1),
    "mixed": lambda rng: np.r_[rng.integers(0, 40, 5_000), rng.integers(33, 4_097, 300), [5_000, 262_144]],
    "no-entries": lambda rng: np.zeros(100, np.int64),
}


@pytest.mark.parametrize("case", sorted(LONG_ROW_CASES))
def test_relocate_long_row_capacity(case):
    """``long_row_capacity`` holds every row that ``torch.nonzero`` finds in
    each tier, and is tight where every row is just over a tier's edge."""
    deg = torch.from_numpy(LONG_ROW_CASES[case](np.random.default_rng(60)).astype(np.int64))
    block_cap, over_cap = long_row_capacity(deg.numel(), int(deg.sum()))
    n_block = torch.nonzero((deg > WARP_MAX) & (deg <= BLOCK_MAX)).numel()
    n_over = torch.nonzero(deg > BLOCK_MAX).numel()
    assert n_block <= block_cap and n_over <= over_cap
    if case == "all-33":
        assert n_block == block_cap
    if case == "all-over-cap":
        assert n_over == over_cap


@pytest.mark.parametrize("pattern", [False, True], ids=["valued", "pattern"])
def test_csr_new_repairs_rows_like_reference(pattern):
    """``CSR.new`` on unsorted rows sorts them through K4's plain version
    (no row or column order), as the JAX ``CSR.new`` does."""
    rng = np.random.default_rng(50)
    degrees = rng.integers(0, 30, 200)
    degrees[::6] = 0
    indptr = np.r_[0, np.cumsum(degrees)].astype(np.int64)
    nnz = int(indptr[-1])
    indices = rng.integers(0, 60, nnz).astype(np.int32)  # unsorted, with duplicates
    vals = None if pattern else rng.standard_normal(nnz).astype(np.float32)
    want = ref.CSR.new(indptr, indices, vals, (200, 60))
    got = CSR.new(torch.from_numpy(indptr), torch.from_numpy(indices),
                  None if pattern else torch.from_numpy(vals), (200, 60))
    assert got.is_sorted()
    got_np = to_numpy(got)
    np.testing.assert_array_equal(got_np["indptr"], np.asarray(want.indptr))
    np.testing.assert_array_equal(got_np["indices"], np.asarray(want.indices))
    if not pattern:
        np.testing.assert_array_equal(got_np["vals"], np.asarray(want.vals))


def test_wrappers_never_fall_back_off_cpu():
    """A tensor that is not on the CPU never takes the plain version: on a
    device without a kernel the wrapper raises."""
    csr = from_reference(CSR_CASES["empty-rows"](), CPU)
    dia = from_reference(ref_csr_to_dia(DIA_CASES["tridiag"][0]()), CPU)
    meta = torch.device("meta")
    meta_csr = csr.to_device(meta)
    order = torch.arange(csr.nrows, dtype=torch.int32)
    with pytest.raises(TypeMismatchError):
        indptr_from_sorted_rows(torch.zeros(5, dtype=torch.int32, device=meta), 3)
    with pytest.raises(TypeMismatchError):
        radix_rank(torch.zeros(5, dtype=torch.int64, device=meta))
    with pytest.raises(TypeMismatchError):
        radix_argsort(torch.zeros(5, dtype=torch.int32, device=meta))
    with pytest.raises(TypeMismatchError):
        relocate_csr(meta_csr, order.to(meta), None)
    with pytest.raises(TypeMismatchError):
        relocate_csr(csr, order.to(meta), None)  # mixed devices
    with pytest.raises(TypeMismatchError):
        csr_spmv(meta_csr, torch.empty(csr.ncols, device=meta))
    with pytest.raises(TypeMismatchError):
        csr_spmv(csr, torch.empty(csr.ncols, device=meta))
    with pytest.raises(TypeMismatchError):
        banded_spmv(dia.to_device(meta), torch.empty(dia.shape[1], device=meta))
    with pytest.raises(ValueError):
        banded_spmv(dia, torch.zeros(3))
    with pytest.raises(ValueError):
        banded_spmv(dia, torch.zeros(dia.shape[1]), layout="diagonal")


def _chip_smoke():
    """The repository's ``chip_smoke.py`` as a module (it imports only the
    standard library, torch and ``benchmark/core`` at the top)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# kernel -> (shapes, bytes worked by hand: each input read once, each output
# written once), at path A (100M entries, 6.25M rows) and path B (33
# diagonals, 1,939,393 rows, 63,999,697 stored entries)
BOUND_CASES = {
    # 33 * 1,939,393 * 4 band + 33 * 4 offsets + 2 * 1,939,393 * 4 for x and y
    "path-B-banded_spmv": ("banded_spmv", dict(ndiag=33, n=1_939_393, m=1_939_393, band_bytes=4), 271_515_152),
    # 6,250,001 * 8 indptr + 1e8 * (4 + 4) ids and values + 2 * 6.25M * 4 for x and y
    "path-A-csr_spmv": ("csr_spmv", dict(n=6_250_000, ncols=6_250_000, nnz=100_000_000), 900_000_008),
    "path-A-csr_spmv-pattern": ("csr_spmv", dict(n=6_250_000, ncols=6_250_000, nnz=100_000_000, pattern=True),
                                500_000_008),
    # 1,939,394 * 8 indptr + 63,999,697 * 8 ids and values + 2 * 1,939,393 * 4
    "path-B-csr_spmv": ("csr_spmv", dict(n=1_939_393, ncols=1_939_393, nnz=63_999_697), 543_027_872),
    # 1e8 * 4 row ids + 6,250,001 * 8 indptr
    "path-A-indptr": ("indptr", dict(nnz=100_000_000, nrows=6_250_000), 450_000_008),
    # 63,999,697 * 4 + 1,939,394 * 8
    "path-B-indptr": ("indptr", dict(nnz=63_999_697, nrows=1_939_393), 271_513_940),
    # in and out: 6,250,001 * 8 indptr + 1e8 * 8 ids and values; ro once: 6.25M * 4
    "path-A-relocate_csr": ("relocate_csr", dict(n=6_250_000, nnz=100_000_000, order_entries=6_250_000,
                                                 value_bytes=4), 1_725_000_016),
    # 6.25M int64 degrees in, 6.25M int32 ranks out
    "path-A-radix_rank": ("radix_rank", dict(n=6_250_000, key_bytes=8), 75_000_000),
    # 1e8 packed int64 pairs in; the int32 permutation and the sorted int64 keys out
    "pair-sort-radix_rank": ("radix_rank", dict(n=100_000_000, key_bytes=8, sorted_keys=True), 2_000_000_000),
    # path F: 4,000,001 * 8 indptr + 68,004,096 * 4 ids in, 68,004,096 * 4 float32 weights out
    "path-F-common_neighbors": ("common_neighbors", dict(n=4_000_000, nnz=68_004_096), 576_032_776),
    # the same ids and indptr in, one int64 sum out
    "path-F-common_neighbors-triangles": ("common_neighbors", dict(n=4_000_000, nnz=68_004_096, mode="triangles"),
                                          304_016_400),
    # directed: the CSR's and the CSC's indptr and ids in, 2 * (32,000,008 + 272,016,384), one int64 sum out
    "path-F-common_neighbors-directed": ("common_neighbors", dict(n=4_000_000, nnz=68_004_096, mode="directed"),
                                         608_032_792),
    # path H: 6,250,001 * 8 indptr + 1e8 * 4 ids + 6.25M * 4 labels in, 6.25M * 4 labels out
    "path-H-label_prop": ("label_prop", dict(n=6_250_000, nnz=100_000_000), 500_000_008),
}


@pytest.mark.parametrize("case", sorted(BOUND_CASES))
def test_chip_smoke_bound_bytes(case):
    """The kernel table's bounds: ``benchmark/core/bounds.py`` for K1–K5
    and K7, ``chip_smoke.common_neighbors_bytes`` for K6, whose integer
    compares leave the bytes to bound it."""
    from benchmark.core import bounds

    kernel, shapes, want = BOUND_CASES[case]
    if kernel == "common_neighbors":
        assert _chip_smoke().common_neighbors_bytes(**shapes) == want
        return
    assert bounds.bound_bytes(kernel, **shapes) == want
    bound_s, bound_by = bounds.bound(kernel, **shapes)
    assert bound_by == "bytes"  # at most 2 flops per 8 bytes: far under the f32 rate
    assert bound_s == pytest.approx(want / 3.35e12)


@pytest.mark.parametrize("n,k", [(4_000, 8), (3_000, 4)])
def test_chip_smoke_planted_graph(n, k):
    """``chip_smoke.planted_coo`` on the CPU: k blocks of n / k vertices,
    about 95% of the entries inside their row's block (all of the other 5%
    outside it), ids shuffled by a permutation (the blocks are not the
    contiguous chunks), rows uniform as path A's and row-major sorted."""
    smoke = _chip_smoke()
    g = torch.Generator()
    g.manual_seed(3)
    nnz = 16 * n
    coo, planted = smoke.planted_coo(g, torch.device("cpu"), n, nnz, k)
    assert coo.shape == (n, n) and coo.nnz == nnz and planted.dtype == torch.int32 and planted.shape == (n,)
    assert torch.equal(torch.bincount(planted.long(), minlength=k), torch.full((k,), n // k))
    inside = float((planted[coo.row.long()] == planted[coo.col.long()]).double().mean())
    assert abs(inside - smoke.PLANTED_INSIDE) < 0.01, inside
    chunks = (torch.arange(n) * k) // n
    assert float((planted.long() == chunks).double().mean()) < 2.0 / k  # about 1 / k after the shuffle
    key = coo.row.long() * n + coo.col.long()
    assert bool((key[1:] >= key[:-1]).all())
    deg = torch.bincount(coo.row.long(), minlength=n).double()
    assert abs(float(deg.mean()) - 16) < 1e-9 and float(deg.std()) < 6  # uniform rows: about Poisson(16)
    with pytest.raises(ValueError, match="equal blocks"):
        smoke.planted_coo(g, torch.device("cpu"), n + 1, nnz, k)


def test_chip_smoke_k7_tier_cases_leave_the_path_draws(monkeypatch):
    """``chip_smoke.k7_cases`` draws ``K7_EDGE_CASES`` from the script's
    generator and ``K7_TIER_CASES`` from one of their own: after it, the
    script's generator stands where the edge cases alone leave it (so path
    A's graph does not depend on the tier cases), and the tier cases do not
    depend on it."""
    smoke = _chip_smoke()
    cpu = torch.device("cpu")
    monkeypatch.setattr(smoke, "K7_EDGE_CASES", tuple((c[0], 300, *c[2:]) for c in smoke.K7_EDGE_CASES[:3]))
    monkeypatch.setattr(smoke, "K7_TIER_CASES", tuple((c[0], 200, *c[2:]) for c in smoke.K7_TIER_CASES[:3]))

    def run(first_seed):
        g = torch.Generator().manual_seed(first_seed)
        cases = list(smoke.k7_cases(g, cpu, seed=5))
        return cases, torch.randint(0, 1 << 30, (8,), generator=g)

    cases, after = run(1)
    g = torch.Generator().manual_seed(1)
    for label, n, avg_deg, k, opts in smoke.K7_EDGE_CASES:
        smoke.k7_case(g, cpu, n, avg_deg, k, **opts)
    assert torch.equal(after, torch.randint(0, 1 << 30, (8,), generator=g))
    assert [c[0] for c in cases] == [c[0] for c in smoke.K7_EDGE_CASES + smoke.K7_TIER_CASES]
    other, _ = run(2)
    tier = len(smoke.K7_EDGE_CASES)
    for (_, csr, labels, _), (_, csr2, labels2, _) in zip(cases[tier:], other[tier:]):
        assert torch.equal(csr.indices, csr2.indices) and torch.equal(labels, labels2)
    assert not torch.equal(cases[0][2], other[0][2])


def test_chip_smoke_path_k_on_the_cpu(monkeypatch, capsys, one_thread):
    """``chip_smoke.path_k`` rehearsed on the CPU at a small size, with the
    card's clocks, memory counters and launch counts stubbed: every check of
    phase 4 holds, at d = 4 and d = 1 alike."""
    smoke = _chip_smoke()
    from sparsebase_tpu_torch.parallel import make_mesh

    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(smoke, "read_launches", lambda path, required: {})
    monkeypatch.setattr(smoke, "POWER_LAW_CARD", (3_000, 48_000))
    monkeypatch.setattr(smoke, "POWER_LAW_HOST", (1_500, 12_000))
    monkeypatch.setattr(smoke, "SLASHBURN_CARD_K", 15)
    cpu = torch.device("cpu")
    meshes = type("J", (), {"mesh": make_mesh(devices=[cpu] * 4), "mesh1": make_mesh(devices=[cpu])})
    g = torch.Generator().manual_seed(0)
    assert smoke.path_k(g, cpu, meshes, 4_000, 32_000, 3_000) == {}
    out = capsys.readouterr().out
    assert "equal to the plain contraction" in out and "every vertex reached" in out
    assert out.count("equal to native.slashburn(greedy=False)") == 2 and out.count("the hubs first") == 2
    # ten results and the coarse CSR's three fields, each the same at d = 4 and d = 1
    assert out.count(": d=4 vs d=1: n=") == 13 and out.count("equal=False") == 0


# rows [1, 1, 2], [0, 1, 3], [0], [1, 2] (degrees 3, 3, 1, 2): 4 deg v and a
# 16-byte indptr pair for each entry the mode counts. jaccard: all nine, deg v
# summing to 22; triangles: not (1, 1) nor the second (0, 1), 16 over seven;
# directed: (0, 1), (0, 2), (1, 3), 6 over three
@pytest.mark.parametrize("mode,want", [("jaccard", 4 * 22 + 16 * 9), ("triangles", 4 * 16 + 16 * 7),
                                       ("directed", 4 * 6 + 16 * 3)])
def test_chip_smoke_streamed_bytes(mode, want):
    csr = CSR(torch.tensor([0, 3, 6, 7, 9]), torch.tensor([1, 1, 2, 0, 1, 3, 0, 1, 2], dtype=torch.int32), None,
              (4, 4))
    assert _chip_smoke().streamed_bytes(csr, mode) == want


# calls that compute K2's or K3's function in one library call: chip_smoke.py
# times them as yardsticks, the package must not make them
_LIBRARY_CALLS = {"sparse_csr_tensor", "mv", "searchsorted"}
# (file, enclosing function) allowed one: K3's plain version, and csr_to_dia,
# whose searchsorted maps each entry to its diagonal among the band's offsets
_ALLOWED = {("ops/kernels/indptr.py", "indptr_plain"), ("convert/kernels.py", "csr_to_dia")}


def test_package_makes_no_library_spmv_or_indptr_call():
    import sparsebase_tpu_torch

    root = Path(sparsebase_tpu_torch.__file__).resolve().parent
    found = set()

    def scan(node, rel, where):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            where = node.name  # calls belong to their innermost function
        if isinstance(node, ast.Call) and isinstance(node.func, (ast.Attribute, ast.Name)):
            name = node.func.attr if isinstance(node.func, ast.Attribute) else node.func.id
            if name in _LIBRARY_CALLS:
                found.add((rel, where, name))
        for child in ast.iter_child_nodes(node):
            scan(child, rel, where)

    for path in sorted(root.rglob("*.py")):
        scan(ast.parse(path.read_text()), path.relative_to(root).as_posix(), "<module>")
    outside = {f for f in found if f[:2] not in _ALLOWED}
    assert not outside, f"library calls in the package: {sorted(outside)}"
    assert ("ops/kernels/indptr.py", "indptr_plain", "searchsorted") in found  # the scan sees calls


@pytest.mark.parametrize("nnz,want", [(0, 1), (1, 1), (TILE, 1), (TILE + 1, 2), (100_000_000, 48_829)])
def test_csr_spmv_tile_count(nnz, want):
    """K2's scratch is sized per tile; a matrix with no entries still has one
    tile, which writes its zero rows."""
    assert tile_count(nnz) == want


def test_build_is_keyed_on_sources_and_fails_loudly(tmp_path, monkeypatch):
    compiles, link = _build.nvcc_commands("nvcc", tmp_path / "lib.so")
    assert all("arch=compute_90a,code=sm_90a" in cmd and "-c" in cmd for cmd in compiles)
    assert "-shared" in link and str(tmp_path / "lib.so") in link
    assert {"indptr.cu", "radix_sort.cu", "relocate.cu"} <= set(_build.SOURCES)
    assert {"indptr", "radix_rank", "relocate_csr"} <= set(_build.KERNELS)
    # one compile per source, each object linked once
    assert [c for cmd in compiles for c in cmd if c.endswith(".cu")] == [str(_build.CSRC / s) for s in _build.SOURCES]
    assert [cmd[-1] for cmd in compiles] == [c for c in link if c.endswith(".o")]
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


# -- K5's pass logic: the host's plan, the device's thinning, as torch ops -----------
# name -> (key bits in all, what the caller states, the plan: (shift, bits, flip))
PLAN_CASES = {
    # path A: degrees in [0, nnz] with nnz = 100M, 27 bits
    "path-A-degrees": (64, 100_000_000 .bit_length(), [(0, 8, 0), (8, 8, 0), (16, 8, 0), (24, 3, 0)]),
    # (row, column) pairs of path A: n = 6.25M, 23 bits each
    "pairs-of-6.25M": (64, [(0, bits_below(6_250_000)), (32, 32 + bits_below(6_250_000))],
                       [(0, 8, 0), (8, 8, 0), (16, 7, 0), (32, 8, 0), (40, 8, 0), (48, 7, 0)]),
    "pairs-200-by-3": (64, [(0, bits_below(3)), (32, 32 + bits_below(200))], [(0, 2, 0), (32, 8, 0)]),
    "pairs-of-one-row": (64, [(0, bits_below(70_000)), (32, 32 + bits_below(1))], [(0, 8, 0), (8, 8, 0), (16, 1, 0)]),
    "pairs-unbounded": (64, [(0, 31), (32, 63)],
                        [(0, 8, 0), (8, 8, 0), (16, 8, 0), (24, 7, 0), (32, 8, 0), (40, 8, 0), (48, 8, 0), (56, 7, 0)]),
    "nothing-stated-int32": (32, None, [(0, 8, 0), (8, 8, 0), (16, 8, 0), (24, 8, 1)]),
    "nothing-stated-int64": (64, None, [(s, 8, int(s == 56)) for s in range(0, 64, 8)]),
    "all-zero": (32, 0, [(0, 1, 0)]),
    "nine-bits": (32, 9, [(0, 8, 0), (8, 1, 0)]),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_radix_plan_passes(case):
    total, key_bits, want = PLAN_CASES[case]
    assert plan_passes(total, key_bits) == want


@pytest.mark.parametrize("total,key_bits", [(32, 32), (64, 64), (64, [(0, 40), (32, 50)]), (64, [(8, 4)]),
                                            (64, [(0, 9), (10, 19), (20, 29), (30, 39), (40, 49)])])
def test_radix_plan_rejects(total, key_bits):
    """Stated bits must stay below the sign bit, ascend without overlap and
    fit the kernel's eight passes."""
    with pytest.raises(ValueError):
        plan_passes(total, key_bits)


def test_radix_scratch_is_sized_per_tile():
    assert scratch_bytes(1) == scratch_bytes(radix_module.TILE) == radix_module.HEADER_BYTES + 2048
    assert scratch_bytes(radix_module.TILE + 1) == radix_module.HEADER_BYTES + 2 * 2048
    assert scratch_bytes(6_250_000) == radix_module.HEADER_BYTES + 2048 * 1526


@pytest.mark.parametrize("n,bound", [(0, 10), (1, 10), (1000, 7), (5000, 1 << 40)])
def test_radix_unique_matches_numpy(n, bound):
    """The distinct keys in ascending order, as ``np.unique`` gives them."""
    keys = np.random.default_rng(n).integers(0, bound, n)
    got = radix_module.radix_unique(torch.from_numpy(keys), key_bits=bits_below(bound))
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), np.unique(keys))


def _packed(rng, n, nseg, ncols):
    return (rng.integers(0, nseg, n).astype(np.int64) << 32) | rng.integers(0, ncols, n)


# name -> (keys, what is stated of them, the passes that run)
PASS_CASES = {
    "path-A-like-degrees": (lambda rng: rng.poisson(16, 5000).astype(np.int64), 27, [0]),
    "all-equal": (lambda rng: np.full(300, 9, np.int64), None, [0]),
    "all-equal-stated": (lambda rng: np.full(300, 9, np.int64), 27, [0]),
    "negative-int64": (lambda rng: -rng.integers(1, 40, 2000), None, [0]),
    "a-single-zero-among-negatives": (lambda rng: np.r_[-rng.integers(1, 40, 2000), 0, -rng.integers(1, 40, 500)],
                                      None, list(range(8))),
    "a-single-zero-among-negatives-int32": (
        lambda rng: np.r_[-rng.integers(1, 40, 2000), 0].astype(np.int32), None, [0, 1, 2, 3]),
    "signed-int32": (lambda rng: rng.integers(-5000, 5000, 3000).astype(np.int32), None, [0, 1, 2, 3]),
    "int16-keys": (lambda rng: rng.integers(-300, 300, 3000).astype(np.int16), None, [0, 1, 2, 3]),
    "uint8-keys": (lambda rng: rng.integers(0, 256, 3000).astype(np.uint8), None, [0]),
    "mask-minus-degrees": (lambda rng: (1 << 27) - 1 - rng.poisson(16, 5000).astype(np.int64), 27, [0]),
    "nnz-minus-degrees-borrows": (lambda rng: 100_000_000 - rng.integers(0, 40, 5000), 27, [0, 1]),
    "packed-seg-col": (lambda rng: _packed(rng, 4000, 37, 1000), [(0, 10), (32, 38)], [0, 1, 2]),
    "packed-one-segment": (lambda rng: _packed(rng, 4000, 1, 70_000), [(0, 17), (32, 32)], [0, 1, 2]),
    "packed-wide-statement": (lambda rng: _packed(rng, 4000, 37, 200), [(0, 23), (32, 55)], [0, 3]),
    "one-key": (lambda rng: np.array([5], np.int64), None, [0]),
    "no-keys": (lambda rng: np.zeros(0, np.int64), None, [0]),
}


@pytest.mark.parametrize("case", sorted(PASS_CASES))
def test_radix_pass_logic_matches_stable_argsort(case):
    """The kernel's pass logic as torch ops (sign flip, planned digits, a
    digit with one bucket skipped, the last pass that runs writing the rank
    or the permutation) equals a stable argsort exactly, and runs the passes
    expected."""
    make, key_bits, want_ran = PASS_CASES[case]
    keys = torch.from_numpy(make(np.random.default_rng(70)))
    perm, ran = radix_passes_plain(keys, key_bits)
    assert ran == want_ran
    assert perm.dtype == torch.int32 and torch.equal(perm, radix_argsort_plain(keys))
    rank, _ = radix_passes_plain(keys, key_bits, inverse=True)
    assert torch.equal(rank, radix_rank_plain(keys))


@pytest.mark.parametrize("dtype", [np.int32, np.int64], ids=["int32", "int64"])
@settings(max_examples=60, deadline=None)
@given(data=st.data())
def test_radix_pass_logic_on_drawn_keys(dtype, data):
    """Keys drawn from the whole range of the type, from a narrow one and
    from a few values (ties), with nothing stated: equal to the stable sort."""
    info = np.iinfo(dtype)
    lo, hi = data.draw(st.sampled_from([(info.min, info.max), (-300, 300), (0, 3), (info.min, info.min + 2)]))
    keys = np.array(data.draw(st.lists(st.integers(lo, hi), min_size=0, max_size=200)), dtype=dtype)
    t = torch.from_numpy(keys)
    perm, _ = radix_passes_plain(t)
    np.testing.assert_array_equal(perm.numpy(), np.argsort(keys, kind="stable"))
    rank, _ = radix_passes_plain(t, inverse=True)
    assert torch.equal(rank, radix_rank_plain(t))


@settings(max_examples=60, deadline=None)
@given(pairs=st.lists(st.tuples(st.integers(0, 40), st.integers(0, 999)), max_size=200))
def test_radix_pass_logic_on_drawn_packed_pairs(pairs):
    """Packed ``(seg << 32) | col`` keys with their live bits stated."""
    seg = np.array([p[0] for p in pairs], dtype=np.int64)
    col = np.array([p[1] for p in pairs], dtype=np.int64)
    keys = torch.from_numpy((seg << 32) | col)
    perm, ran = radix_passes_plain(keys, [(0, bits_below(1000)), (32, 32 + bits_below(41))])
    assert set(ran) <= {0, 1, 2}
    np.testing.assert_array_equal(perm.numpy(), np.lexsort((np.arange(len(pairs)), col, seg)))


def test_radix_argsort_returns_sorted_keys_on_cpu():
    keys = torch.from_numpy(np.random.default_rng(71).integers(-50, 50, 500))
    perm, sorted_keys = radix_argsort(keys, return_keys=True)
    assert torch.equal(sorted_keys, torch.sort(keys, stable=True).values)
    assert torch.equal(perm, radix_argsort(keys, key_bits=None))


def _calls_in(func):
    """Names of everything ``func`` calls: ``f(...)`` and ``x.f(...)``."""
    names = set()
    for node in ast.walk(func):
        if isinstance(node, ast.Call) and isinstance(node.func, (ast.Attribute, ast.Name)):
            names.add(node.func.attr if isinstance(node.func, ast.Attribute) else node.func.id)
    return names


def test_radix_cuda_route_reads_nothing_back():
    """The functions on K5's CUDA route make no call that reads a tensor
    back to the host (``aminmax``, ``.item()``, ``int(...)`` and their like)
    and none that sorts (``torch.sort``, ``torch.argsort``); the plain
    versions, for CPU tensors, are where the library sort lives."""
    tree = ast.parse(Path(radix_module.__file__).read_text())
    funcs = {node.name: node for node in tree.body if isinstance(node, ast.FunctionDef)}
    host_reads = {"aminmax", "item", "int", "float", "bool", "tolist", "cpu", "numpy", "min", "max", "amin", "amax",
                  "nonzero", "unique", "synchronize"}
    sorts = {"sort", "argsort", "msort", "topk"}
    assert not _calls_in(funcs["_radix_sort"]) & (host_reads | sorts)
    for name in ("radix_rank", "radix_argsort"):
        assert not _calls_in(funcs[name]) & (host_reads | sorts), name
        assert "_radix_sort" in _calls_in(funcs[name])
    assert "argsort" in _calls_in(funcs["radix_rank_plain"])  # the scan sees calls
    source = (Path(radix_module.__file__).parents[2] / "csrc" / "radix_sort.cu").read_text()
    for library in ("cub::", "thrust::", "#include <cub", "#include <thrust"):
        assert library not in source


# -- DegreeReorder, descending, with empty rows ---------------------------------------
DESCENDING_CASES = {
    "one-empty-row": lambda rng: np.r_[rng.integers(1, 30, 200), 0, rng.integers(1, 30, 99)],
    "many-empty-rows": lambda rng: np.where(rng.random(400) < 0.3, 0, rng.integers(1, 30, 400)),
    "a-long-row": lambda rng: np.r_[rng.integers(0, 20, 300), 700],
    "all-empty": lambda rng: np.zeros(50, np.int64),
}


@pytest.mark.parametrize("case", sorted(DESCENDING_CASES))
def test_degree_reorder_descending_matches_reference(case):
    """``DegreeReorder(ascending=False)`` sorts ``mask - degrees`` with its
    bits stated; the order and its ties equal the JAX package's, which
    sorts ``-degrees``. The kernel's pass logic gives the same on those keys."""
    degrees = DESCENDING_CASES[case](np.random.default_rng(80))
    ref_csr = csr_with(81, degrees, 300)
    want = np.asarray(RefDegreeReorder(ascending=False).get_reorder(ref_csr))
    csr = from_reference(ref_csr, CPU)
    got = DegreeReorder(ascending=False).get_reorder(csr)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    bits = csr.nnz.bit_length()
    model, ran = radix_passes_plain((1 << bits) - 1 - csr.degrees(), bits, inverse=True)
    np.testing.assert_array_equal(model.numpy(), want)
    if degrees.max(initial=0) < 256:
        assert ran == [0]  # one empty row does not wake the high bytes
    np.testing.assert_array_equal(DegreeReorder().get_reorder(csr).numpy(),
                                  np.asarray(RefDegreeReorder().get_reorder(ref_csr)))


# -- the (row, column) sort of a COO -----------------------------------------------------
def canonical(row, col, vals):
    """Entries in (row, column, value) order: duplicates of one coordinate
    in one order, whatever the sort that placed them."""
    order = np.lexsort((np.zeros_like(row) if vals is None else vals, col, row))
    return row[order], col[order], None if vals is None else vals[order]


PAIR_SORT_CASES = {
    "square": dict(n=300, m=300, nnz=4000),
    "rectangular": dict(n=200, m=450, nnz=2500),
    "pattern": dict(n=300, m=300, nnz=3000, pattern=True),
    "one-row": dict(n=1, m=500, nnz=800),
    "no-entries": dict(n=20, m=20, nnz=0),
}


@pytest.mark.parametrize("case", sorted(PAIR_SORT_CASES))
def test_coo_pair_sort_matches_reference(case):
    """``sort_by_pairs``, ``COO.sort_rowmajor`` and ``permute_2d`` of a COO
    against the JAX package after canonical ordering of duplicates (its
    device sort leaves their order open): ids exactly, values exactly (they
    are moved, not computed). Against its own plain version the port's sort
    is exact as it stands, duplicates in input order."""
    kw = dict(PAIR_SORT_CASES[case])
    n, m, nnz, pattern = kw["n"], kw["m"], kw["nnz"], kw.get("pattern", False)
    rng = np.random.default_rng(90)
    row = rng.integers(0, n, nnz).astype(np.int32)
    col = rng.integers(0, m, nnz).astype(np.int32)
    if nnz:
        row[:20], col[:20] = row[0], col[0]  # 20 copies of one coordinate
    vals = None if pattern else rng.standard_normal(nnz).astype(np.float32)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731

    got = sort_by_pairs(t(row), t(col), t(vals), major_bound=n, minor_bound=m)
    plain = sort_by_pairs_plain(t(row), t(col), t(vals))
    order = np.lexsort((np.arange(nnz), col, row))  # the stable sort
    for g, p, w in zip(got, plain, (row[order], col[order], None if pattern else vals[order])):
        if w is None:
            assert g is None and p is None
        else:
            np.testing.assert_array_equal(g.numpy(), w)
            np.testing.assert_array_equal(p.numpy(), w)

    want = ref.COO.new(row, col, vals, (n, m))
    want_np = canonical(np.asarray(want.row), np.asarray(want.col), None if pattern else np.asarray(want.vals))
    coo = COO(t(row), t(col), t(vals), (n, m)).sort_rowmajor()
    assert coo.is_sorted()
    got_np = canonical(coo.row.numpy(), coo.col.numpy(), None if pattern else coo.vals.numpy())
    for g, w in zip(got_np, want_np):
        assert (g is None and w is None) or np.array_equal(g, w)

    ro, co = rng.permutation(n).astype(np.int32), rng.permutation(m).astype(np.int32)
    want_p = ref_permute_2d(want, ro, co)
    got_p = permute_2d(coo, t(ro), t(co))
    assert isinstance(got_p, COO) and got_p.is_sorted()
    want_np = canonical(np.asarray(want_p.row), np.asarray(want_p.col), None if pattern else np.asarray(want_p.vals))
    got_np = canonical(got_p.row.numpy(), got_p.col.numpy(), None if pattern else got_p.vals.numpy())
    for g, w in zip(got_np, want_np):
        assert (g is None and w is None) or np.array_equal(g, w)


# -- what the card wrappers do to ids, offsets and values before a launch -----------
@pytest.mark.parametrize("dtype", [torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64])
def test_kernel_ids_and_offsets_convert(dtype):
    ids = torch.tensor([0, 3, 3, 100], dtype=dtype)
    narrow = kernel_ids(ids, "ids")
    assert narrow.dtype == torch.int32 and narrow.is_contiguous() and narrow.tolist() == [0, 3, 3, 100]
    wide = kernel_offsets(ids, "offsets")
    assert wide.dtype == torch.int64 and wide.is_contiguous() and wide.tolist() == [0, 3, 3, 100]
    if dtype == torch.int32:
        assert narrow.data_ptr() == ids.data_ptr()  # already the kernel's type: no copy
    if dtype == torch.int64:
        assert wide.data_ptr() == ids.data_ptr()
    strided = torch.arange(10, dtype=dtype)[::2]
    assert kernel_ids(strided, "ids").is_contiguous() and kernel_offsets(strided, "offsets").is_contiguous()


def test_kernel_ids_overflow_and_types_raise():
    with pytest.raises(TypeMismatchError):
        kernel_ids(torch.tensor([0, 2**31], dtype=torch.int64), "ids")
    with pytest.raises(TypeMismatchError):
        kernel_ids(torch.tensor([-(2**31) - 1], dtype=torch.int64), "ids")
    assert kernel_ids(torch.tensor([2**31 - 1], dtype=torch.int64), "ids").item() == 2**31 - 1
    for bad in (torch.tensor([1.0]), torch.tensor([True])):
        with pytest.raises(TypeMismatchError):
            kernel_ids(bad, "ids")
        with pytest.raises(TypeMismatchError):
            kernel_offsets(bad, "offsets")


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("offset_dtype", [torch.int32, torch.int64], ids=["offsets32", "offsets64"])
def test_wrappers_take_any_index_dtype(id_dtype, offset_dtype):
    """``convert(CSR)`` (K3), ``spmv`` (K2) and ``relocate_csr`` (K4) on
    ids and offsets of other integer types give what int32 ids and int64
    offsets give, and the ids come back in the caller's type."""
    row, col, vals = coo_graph(100, n=300, m=300, nnz=3000)
    rng = np.random.default_rng(101)
    ro, co = rng.permutation(300).astype(np.int32), rng.permutation(300).astype(np.int32)
    x = torch.from_numpy(rng.standard_normal(300).astype(np.float32))
    base = CSR(indptr_plain(torch.from_numpy(row), 300), torch.from_numpy(col), torch.from_numpy(vals), (300, 300))
    indptr = indptr_from_sorted_rows(torch.from_numpy(row).to(id_dtype), 300)
    assert indptr.dtype == torch.int64 and torch.equal(indptr, base.indptr)
    csr = CSR(base.indptr.to(offset_dtype), base.indices.to(id_dtype), base.vals, base.shape)
    assert torch.equal(csr_spmv(csr, x), csr_spmv(base, x))
    for orders in ((torch.from_numpy(ro), torch.from_numpy(co)), (torch.from_numpy(ro).long(), None), (None, None)):
        got = relocate_csr(csr, *orders)
        want = relocate_csr(base, *orders)
        assert got.indices.dtype == id_dtype
        assert torch.equal(got.indices.to(torch.int32), want.indices)
        assert torch.equal(got.indptr.to(torch.int64), want.indptr) and torch.equal(got.vals, want.vals)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float64, torch.int32, torch.int8],
                         ids=["bf16", "f16", "f64", "int32", "int8"])
def test_csr_spmv_casts_values_to_x(dtype):
    """Values of any type are cast to ``x``'s float32, as the reference's
    ``spmv_csr`` casts them: the same ``y`` as float32 values of the same
    magnitudes."""
    ref_csr = CSR_CASES["empty-rows"]()
    csr = from_reference(ref_csr, CPU)
    vals = torch.from_numpy(np.random.default_rng(110).integers(-5, 6, csr.nnz).astype(np.float32))
    x = torch.from_numpy(np.random.default_rng(111).standard_normal(csr.ncols).astype(np.float32))
    typed = CSR(csr.indptr, csr.indices, vals.to(dtype), csr.shape)
    y = csr_spmv(typed, x)
    assert y.dtype == torch.float32
    assert torch.equal(y, csr_spmv(CSR(csr.indptr, csr.indices, vals, csr.shape), x))
    want = np.asarray(ref_spmv_csr(ref.CSR.new(np.asarray(ref_csr.indptr), np.asarray(ref_csr.indices),
                                               vals.numpy(), ref_csr.shape), x.numpy(), method="segment"))
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-5)


# -- K6 (common neighbours): the tier plan and a model of one task's count ---------
def _k6_constants():
    """The constants of ``csrc/common_neighbors.cu`` (``constexpr ... kName = v;``)."""
    import re

    src = (Path(__file__).resolve().parents[1] / "sparsebase_tpu_torch" / "csrc" / "common_neighbors.cu").read_text()
    return {name: int(value) for name, value in re.findall(r"constexpr \w+ (k\w+) = (\d+);", src)}


def k6_tier_of(d, k):
    """``tier_of`` of ``csrc/common_neighbors.cu``."""
    return 0 if d == 0 else 1 if d <= 8 else 2 if d <= 16 else 3 if d <= k["kGroupStage"] else 4 if d <= k[
        "kMidCap"] else 5


def k6_plan(deg, seed):
    """``classify_count`` and ``classify_place`` in Python, the rows taken in
    a shuffled order (the atomics fix none): ``(rows, tier_off,
    chunk_end)`` as the kernel leaves them."""
    k = _k6_constants()
    tiers, chunk = k["kTiers"], k["kChunk"]
    count = [0] * tiers
    for d in deg:
        count[k6_tier_of(d, k)] += 1
    off = [0, 0]
    for t in range(1, tiers):
        off.append(off[t] + count[t])
    cursor = [0] * tiers
    rows = [-1] * len(deg)
    chunk_end = [-1] * len(deg)
    for r in np.random.default_rng(seed).permutation(len(deg)).tolist():
        t = k6_tier_of(deg[r], k)
        if t == 5:
            chunks = -(-deg[r] // chunk)
            old = cursor[5]
            cursor[5] += (1 << 33) | chunks
            pos = off[5] + (old >> 33)
            rows[pos], chunk_end[pos] = r, (old & ((1 << 33) - 1)) + chunks
        elif t > 0:
            rows[off[t] + cursor[t]] = r
            cursor[t] += 1
    return rows, off, chunk_end


K6_PLAN_DEGREES = [0, 1, 8, 9, 16, 17, 32, 33, 1_024, 1_025, 8_192, 8_193, 20_000, 0, 5, 40, 0, 3, 1, 12, 3_000]


@pytest.mark.parametrize("grid", [1, 3, 7, 64])
def test_k6_plan_places_every_entry_in_one_task(grid):
    """The kernel's plan on degrees at every tier edge (0, 1, 8, 9, 16, 17,
    32, 33, 1,024, 1,025 and rows past the staged capacity): each row with
    entries lands once, in its tier. With the kernel's tasks (a row in
    tiers 1-4; in tier 5, chunks of ``kChunk`` entries, each block taking a
    run of consecutive chunks as ``cn_blocks`` does, its row found in
    ``chunk_end``) every entry falls in exactly one task, within its row."""
    k = _k6_constants()
    chunk = k["kChunk"]
    deg = K6_PLAN_DEGREES
    indptr = np.r_[0, np.cumsum(deg)]
    rows, off, chunk_end = k6_plan(deg, seed=grid)
    tiers = [sorted(deg[r] for r in rows[off[t]:off[t + 1]]) for t in range(1, k["kTiers"])]
    assert tiers == [[1, 1, 3, 5, 8], [9, 12, 16], [17, 32], [33, 40, 1_024], [1_025, 3_000, 8_192, 8_193, 20_000]]
    assert sorted(rows[:off[-1]]) == [r for r, d in enumerate(deg) if d > 0]

    covered = np.zeros(indptr[-1], np.int64)
    for t in range(1, 5):
        for r in rows[off[t]:off[t + 1]]:
            covered[indptr[r]:indptr[r + 1]] += 1
    r0, r1 = off[5], off[6]
    ends = chunk_end[r0:r1]
    assert ends == sorted(ends)
    per = -(-ends[-1] // grid)
    for block in range(grid):
        for c in range(block * per, min((block + 1) * per, ends[-1])):
            at = r0 + int(np.searchsorted(ends, c, side="right"))  # first r with chunk_end[r] > c
            r, d = rows[at], deg[rows[at]]
            j = c - (chunk_end[at] - -(-d // chunk))
            lo, hi = j * chunk, min((j + 1) * chunk, d)
            assert 0 <= lo < hi <= d
            covered[indptr[r] + lo:indptr[r] + hi] += 1
    assert bool((covered == 1).all())


def test_k6_plan_of_empty_rows():
    rows, off, _ = k6_plan([0, 0, 0], seed=0)
    assert rows == [-1, -1, -1] and off == [0] * (_k6_constants()["kTiers"] + 1)


class K6TaskModel:
    """One K6 task's count as ``csrc/common_neighbors.cu`` does it, in
    Python: row u's list S (N(u), or I(u) in directed mode) staged as
    samples ``S[t * stride]`` in ``cap`` slots, and each entry counted in
    the direction ``policy`` picks ("rule": the kernel's choice, a lane
    streams N(v) up to ``kLaneStreamMax``, a group streams when deg v <=
    kStreamCost * |S| * log2(deg v); "stream" or "search": always;
    "deferred": ``cn_deferred``'s, nothing staged and candidates from the
    shorter list)."""

    def __init__(self, indptr, ids, mode, in_ptr=None, in_ids=None, cap=32, policy="rule"):
        self.indptr, self.ids, self.mode = indptr, ids, mode
        self.in_ptr, self.in_ids, self.cap, self.policy = in_ptr, in_ids, cap, policy
        k = _k6_constants()
        self.lane_max, self.cost = k["kLaneStreamMax"], k["kStreamCost"]

    @staticmethod
    def _bound(a, lo, hi, x, upper):  # first p in [lo, hi) failing a[p] < x (<= x when upper)
        while lo < hi:
            mid = (lo + hi) // 2
            if (a[mid] <= x) if upper else (a[mid] < x):
                lo = mid + 1
            else:
                hi = mid
        return lo

    def _s_bound(self, x, upper):
        i = self._bound(self.samples, 0, len(self.samples), x, upper)
        if self.stride == 1:
            return i
        lo = 0 if i == 0 else (i - 1) * self.stride + 1
        hi = len(self.s) if i == len(self.samples) else i * self.stride
        return self._bound(self.s, lo, hi, x, upper)

    def _skip(self, x, u, v):
        return (self.mode == "triangles" and x in (u, v)) or (self.mode == "directed" and (x <= u or x == v))

    def stream(self, nv, u, v):
        c = 0
        for k, y in enumerate(nv):
            if (k > 0 and nv[k - 1] == y) or self._skip(y, u, v):
                continue
            lb = self._s_bound(y, False)
            if lb < len(self.s) and self.s[lb] == y:
                c += self._s_bound(y, True) - lb if self.mode == "jaccard" else 1
        return c

    def search(self, nv, u, v):
        c = 0
        for t, x in enumerate(self.s):
            if (self.mode != "jaccard" and t > 0 and self.s[t - 1] == x) or self._skip(x, u, v):
                continue
            lb = self._bound(nv, 0, len(nv), x, False)
            c += lb < len(nv) and nv[lb] == x
        return c

    def row(self, u):
        """Row u's counts: a float32 weight per entry (jaccard) or the sum."""
        su, eu = int(self.indptr[u]), int(self.indptr[u + 1])
        lists = (self.in_ptr, self.in_ids) if self.mode == "directed" else (self.indptr, self.ids)
        self.s = lists[1][int(lists[0][u]):int(lists[0][u + 1])]
        if self.policy == "deferred":  # stride 0: nothing staged, the whole list searched in device memory
            self.stride, self.samples = 0, self.s[:0]
        else:
            self.stride = 1
            while -(-len(self.s) // self.stride) > self.cap:
                self.stride *= 2
            self.samples = self.s[::self.stride]
        weights, total = [], 0
        for j in range(eu - su):
            v = int(self.ids[su + j])
            repeat = j > 0 and self.ids[su + j - 1] == v
            if self.mode != "jaccard" and (repeat or (v == u if self.mode == "triangles" else v <= u)):
                continue
            nv = self.ids[int(self.indptr[v]):int(self.indptr[v + 1])]
            dv = len(nv)
            if self.policy == "rule":
                streams = dv <= self.lane_max or dv <= self.cost * len(self.s) * dv.bit_length()
            elif self.policy == "deferred":
                streams = dv <= len(self.s)
            else:
                streams = self.policy == "stream"
            c = self.stream(nv, u, v) if streams else self.search(nv, u, v)
            if self.mode == "jaccard":
                weights.append(np.float32(c / max(eu - su + dv - c, 1)))
            total += c
        return weights if self.mode == "jaccard" else total


@st.composite
def k6_patterns(draw):
    """Small patterns with hubs (two of them adjacent, each other's
    neighbours), duplicates, self-loops and sometimes fewer columns than
    rows."""
    n = draw(st.integers(1, 24))
    ncols = draw(st.integers(1, n)) if draw(st.booleans()) else n
    pairs = draw(st.lists(st.tuples(st.integers(0, n - 1), st.integers(0, ncols - 1)), max_size=70))
    for h in range(draw(st.integers(0, 2))):  # hub rows 0 and 1, adjacent
        cols = draw(st.lists(st.integers(0, ncols - 1), min_size=ncols // 2, max_size=2 * ncols))
        pairs += [(min(h, n - 1), c) for c in cols]
    if ncols == n and draw(st.booleans()):
        pairs += [(b, a) for a, b in pairs]
    r = np.array([a for a, _ in pairs], np.int64)
    c = np.array([b for _, b in pairs], np.int64)
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    indptr = np.r_[0, np.cumsum(np.bincount(r, minlength=n))]
    return CSR(torch.from_numpy(indptr), torch.from_numpy(c.astype(np.int32)), None, (n, ncols))


@pytest.mark.parametrize("policy", ["rule", "stream", "search", "deferred"])
@settings(max_examples=60, deadline=None)
@given(csr=k6_patterns(), cap=st.sampled_from([1, 2, 3, 32]))
def test_k6_task_model_matches_plain(policy, csr, cap):
    """The model of K6's count, in either direction and with S staged whole
    or as samples, equals ``common_neighbors_plain`` in all three modes."""
    from sparsebase_tpu_torch import CSC
    from sparsebase_tpu_torch.ops.kernels import common_neighbors_plain

    indptr, ids = csr.indptr.numpy(), csr.indices.numpy()
    modes = ["jaccard", "triangles"] + (["directed"] if csr.nrows == csr.ncols else [])
    for mode in modes:
        csc = csr.convert(CSC) if mode == "directed" else None
        in_ptr, in_ids = (csc.indptr.numpy(), csc.indices.numpy()) if csc is not None else (None, None)
        model = K6TaskModel(indptr, ids, mode, in_ptr, in_ids, cap=cap, policy=policy)
        per_row = [model.row(u) for u in range(csr.nrows)]
        want = common_neighbors_plain(csr, mode, csc)
        if mode == "jaccard":
            got = np.array([w for ws in per_row for w in ws], np.float32)
            np.testing.assert_array_equal(got, want.numpy())
        else:
            assert sum(per_row) == int(want), mode


@pytest.fixture
def one_thread():
    """torch's CPU ops on one thread: beside the suite's other workers more
    threads oversubscribe the cores, and a rehearsal's many small passes
    then slow down many-fold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_chip_smoke_path_l_on_the_cpu(monkeypatch, capsys, one_thread):
    """``chip_smoke.path_l`` rehearsed on the CPU at a small size (8 cliques
    K_16, a uniform graph of 128 vertices, a power-law graph of 2,000; ``MAX_DENSE_ELEMS`` cut so that the cliques' tile at d = 4 sits on
    it), with the card's clocks, memory counters and launch counts stubbed
    and the suite's table run on the CPU: every check of phase 4 holds."""
    smoke = _chip_smoke()
    from sparsebase_tpu_torch import bench_suite
    from sparsebase_tpu_torch.parallel import ring

    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(smoke, "read_launches", lambda path, required: {})
    monkeypatch.setattr(smoke, "PATH_L_CLIQUES", (8, 16))
    monkeypatch.setattr(smoke, "PATH_L_N", 128)
    monkeypatch.setattr(smoke, "POWER_LAW_CARD", (2_000, 16_000))
    monkeypatch.setattr(ring, "MAX_DENSE_ELEMS", 32 * 4 * 32)  # rows 32 at d = 4
    run_distributed = bench_suite.run_distributed
    monkeypatch.setattr(bench_suite, "run_distributed", lambda **kw: run_distributed(**{"device": "cpu", **kw}))
    monkeypatch.setitem(bench_suite.MATRICES, "rand-20k", lambda device: bench_suite.mesh_graph(30, device=device))
    g = torch.Generator().manual_seed(0)
    launches, suite = smoke.path_l(g, torch.device("cpu"))
    assert launches == {} and suite["devices"] == 4 and suite["rand-20k"]["n"] == 900
    out = capsys.readouterr().out
    assert "4480 triangles, every weight 14/16" in out and "d=1 raised: 'ring.triangle_count" in out
    assert out.count("equal to K6, the weights equal to K6's bit for bit") == 1
    # jaccard_flat of (a), the three weights of (b) and jaccard_flat of (c) at d = 4 and d = 1, each K6's
    assert out.count("vs K6 JaccardWeights: n=") == 6 and out.count("equal=False") == 0


def test_chip_smoke_path_m_on_the_cpu(monkeypatch, capsys, one_thread):
    """``chip_smoke.path_m`` rehearsed on the CPU at a small size (the tool's
    graph at 4,096 vertices; two gloo processes of the script on the CPU,
    under its time limit; path O's ladders on 2,048 vertices down to 1,024,
    SlashBurn on a power-law graph of 2,000; path P's cliques 4 K_16), with
    the card's clocks and launch counts stubbed: every field of the two
    processes equals the single-process mesh's, so do the results and stats
    of paths N, O and P and the processes' suite tables, and every check of
    the four paths holds on the one process."""
    smoke = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(smoke, "read_launches", lambda path, required: {})
    monkeypatch.setattr(smoke, "require_launches", lambda path, counts, required: None)  # nothing launches here
    monkeypatch.setattr(smoke, "PATH_O_N", 1 << 11)
    monkeypatch.setattr(smoke, "PATH_O_COARSEN_UNTIL", 1 << 10)
    monkeypatch.setattr(smoke, "POWER_LAW_HOST", (2_000, 16_000))
    monkeypatch.setattr(smoke, "PATH_O_SLASHBURN_K", 64)
    monkeypatch.setattr(smoke, "PATH_P_CLIQUES", (4, 16))
    launches, launches_n, launches_o, launches_p, err = smoke.path_m(torch.device("cpu"), 0, n=1 << 12)
    assert launches == {} and launches_n == {} and launches_o == {} and launches_p == {} and err == 0.0
    out = capsys.readouterr().out
    assert "phase 4 path M gloo: 2 processes x 2 shards equal to the single-process mesh of 4 shards bit for bit" in out
    assert "path M dist.rcm_reorder vs the plain (level, degree, id) rank: n=4096 equal=True" in out
    assert "path M halo.spmv, one process, vs plain SpMV of the whole CSR: rows=4096" in out
    assert "phase 3 path M NCCL route: skipped" in out and out.count("phase 3 path M rank ") == 2
    assert "phase 4 path N gloo: 2 processes equal to the single-process mesh of 4 shards bit for bit" in out
    assert "path N halo.bfs_levels vs dist.bfs_levels: n=4096 equal=True" in out
    assert out.count("  path N ") == 9  # dist.spmv's rows, four equal results, three refinements, the features
    assert "phase 4 path O gloo: 2 processes equal to the single-process mesh of 4 shards bit for bit" in out
    assert "path O coarsen values vs a plain contraction by the map: n=" in out and out.count("  path O ") == 14
    assert "path O slashburn_reorder (hub_order=True) vs native.slashburn(greedy=False): n=2000 equal=True" in out
    assert "phase 4 path P (a) the cliques (n=64, 960 entries): 2240 triangles" in out
    assert "phase 4 path P gloo: 2 processes equal to the single-process mesh of 4 shards bit for bit" in out
    assert "path P (c) sharded2d.spmv y,x (K2 per tile) vs plain SpMV of the whole CSR: rows=4096" in out
    assert out.count("  path P ") == 9  # (a), (b), both orientations' y and degrees, two stacked fields, (e)
    assert "run_distributed equal but for its times to one process's" in out
