"""The hand-written CUDA kernels against their plain versions, on a CUDA
card. Without one these tests skip (the condition is evaluated when each
test runs, not at import).

On the card: ``python -m pytest --noconftest tests/test_torch_cuda.py -q``.
The kernels are built from ``sparsebase_tpu_torch/csrc`` on first use.

The SpMV kernels (K1, K2) are held per row to ``|y_k - y_p| <= 4 * deg_i *
eps_f32 * (|A| |x|)_i``, which bounds two f32 sums of the same terms taken
in different orders. K3 (indptr), K4 (relocation) and K5 (radix sort)
compute exact integer results, and equal their plain versions bit for bit.
"""

import warnings

import numpy as np
import pytest
import torch

from sparsebase_tpu_torch import COO, CSR, DIA, _build, preprocess_pipeline, spmv
from sparsebase_tpu_torch.convert.kernels import sort_by_pairs, sort_by_pairs_plain
from sparsebase_tpu_torch.ops.kernels import (
    banded_spmv,
    csr_spmv,
    csr_spmv_plain,
    dia_spmv_plain,
    indptr_from_sorted_rows,
    indptr_plain,
    radix_argsort,
    radix_argsort_plain,
    radix_rank,
    radix_rank_plain,
    relocate_csr,
    relocate_csr_plain,
)
from sparsebase_tpu_torch.ops.kernels.csr_spmv import TILE
from sparsebase_tpu_torch.ops.kernels.label_prop import SPLIT_ROWS, split_rows
from sparsebase_tpu_torch.ops.permute import permute_2d
from sparsebase_tpu_torch.ops.reorder import DegreeReorder
from sparsebase_tpu_torch.parallel import halo, ring
from sparsebase_tpu_torch.utils.exceptions import TypeMismatchError

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
@pytest.mark.parametrize("shape", [(100_003, 100_003), (70_001, 90_000), (90_000, 70_001)],
                         ids=["square", "rectangular", "tall"])
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
    assert torch.equal(y, csr_spmv(csr, x))  # the same y bit for bit on every run


def off_alignment(t):
    """A contiguous copy of ``t`` starting one element past a 16-byte boundary."""
    buf = torch.empty((t.numel() + 1,), dtype=t.dtype, device=t.device)
    buf[1:] = t
    return buf[1:]


def every_seventh_row_empty(g, d):
    deg = torch.randint(0, 40, (20_000,), generator=g, device=d)
    deg[::7] = 0
    return deg


# name -> row degrees (K2 splits the entries into tiles of TILE)
CSR_EDGE_CASES = {
    "every-seventh-row-empty": every_seventh_row_empty,
    # rows of exactly one tile, one tile and one entry, over three tiles;
    # rows 2, 3, 4 and 8 start on tile edges, row 2 empty
    "tile-edges": lambda g, d: torch.cat([
        torch.tensor([5, TILE - 5, 0, TILE, TILE + 1, 0, 0, TILE - 1, 3 * TILE + 7, 0, TILE, 1], device=d),
        torch.randint(0, 40, (5_000,), generator=g, device=d)]),
    "rows-of-0-to-3": lambda g, d: torch.randint(0, 4, (50_000,), generator=g, device=d),
    "no-entries": lambda g, d: torch.zeros((1_000,), dtype=torch.int64, device=d),
    "one-row-over-five-tiles": lambda g, d: torch.tensor([5 * TILE + 3], device=d),
    "one-row-of-7": lambda g, d: torch.tensor([7], device=d),
    "trailing-empty-rows": lambda g, d: torch.cat([torch.full((40,), TILE // 8, device=d),
                                                   torch.zeros((30,), dtype=torch.int64, device=d)]),
}


@pytest.mark.parametrize("misaligned", [False, True], ids=["aligned", "off-alignment"])
@pytest.mark.parametrize("pattern", [False, True], ids=["valued", "pattern"])
@pytest.mark.parametrize("case", sorted(CSR_EDGE_CASES))
def test_csr_kernel_tile_edges(dev, gen, case, pattern, misaligned):
    deg = CSR_EDGE_CASES[case](gen, dev)
    indptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), deg.cumsum(0)])
    nnz, ncols = int(indptr[-1]), 3_000
    cols = torch.randint(0, ncols, (nnz,), generator=gen, device=dev, dtype=torch.int32)
    vals = None if pattern else torch.randn((nnz,), generator=gen, device=dev)
    if misaligned:  # the kernel's scalar loads
        cols = off_alignment(cols)
        vals = None if pattern else off_alignment(vals)
    csr = CSR(indptr, cols, vals, (deg.numel(), ncols))
    x = torch.randn((ncols,), generator=gen, device=dev)
    before = _build.launch_counts()["csr_spmv"]
    y = csr_spmv(csr, x)
    assert _build.launch_counts()["csr_spmv"] == before + 1
    abs_csr = CSR(indptr, cols, None if pattern else vals.abs(), csr.shape)
    assert_rows_within(y, csr_spmv_plain(csr, x), deg, csr_spmv_plain(abs_csr, x.abs()))
    assert torch.equal(y, csr_spmv(csr, x))


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


def sorted_rows(gen, dev, nrows, nnz, lo=0, hi=None):
    row = torch.randint(lo, nrows if hi is None else hi, (nnz,), generator=gen, device=dev, dtype=torch.int32)
    return torch.sort(row).values


# name -> (row ids, nrows), made on the card
INDPTR_CASES = {
    "leading-empty": lambda g, d: (sorted_rows(g, d, 50_000, 400_000, lo=1_000), 50_000),
    "trailing-empty": lambda g, d: (sorted_rows(g, d, 50_000, 400_000, hi=40_000), 50_000),
    "interior-empty": lambda g, d: (sorted_rows(g, d, 300_000, 200_000), 300_000),
    "no-entries": lambda g, d: (torch.zeros((0,), dtype=torch.int32, device=d), 1_000),
    "gap-of-1M-rows": lambda g, d: (torch.cat([sorted_rows(g, d, 3, 100),
                                               torch.full((50,), 1_000_003, dtype=torch.int32, device=d)]), 1_000_010),
    "path-a-like": lambda g, d: (sorted_rows(g, d, 625_000, 10_000_000), 625_000),
    # K3 loads 16-byte groups: an array one element off alignment, fewer
    # entries than a thread's run, and run heads on every 512-id chunk seam
    "off-alignment": lambda g, d: (sorted_rows(g, d, 50_000, 400_001)[1:], 50_000),
    "1-entry": lambda g, d: (sorted_rows(g, d, 10, 1), 10),
    "3-entries": lambda g, d: (sorted_rows(g, d, 10, 3), 10),
    "15-entries": lambda g, d: (sorted_rows(g, d, 10, 15), 10),
    "17-entries": lambda g, d: (sorted_rows(g, d, 10, 17), 10),
    "heads-on-chunk-seams": lambda g, d: (torch.arange(1_000_000, dtype=torch.int32, device=d) // 512, 1_960),
    "heads-on-seams-off-alignment": lambda g, d: (
        off_alignment(torch.arange(1_000_000, dtype=torch.int32, device=d) // 512), 1_960),
    "heads-on-seams-empty-rows-between": lambda g, d: (torch.arange(1_000_000, dtype=torch.int32, device=d) // 512 * 3,
                                                       5_870),
}


@pytest.mark.parametrize("case", sorted(INDPTR_CASES))
def test_indptr_kernel_matches_plain(dev, gen, case):
    row, nrows = INDPTR_CASES[case](gen, dev)
    before = _build.launch_counts()["indptr"]
    got = indptr_from_sorted_rows(row, nrows)
    assert _build.launch_counts()["indptr"] == before + 1
    assert torch.equal(got, indptr_plain(row, nrows))


# name -> keys, made on the card
RANK_CASES = {
    "ascending-ties": lambda g, d: torch.randint(0, 40, (1_000_003,), generator=g, device=d),
    "descending": lambda g, d: -torch.randint(0, 40, (1_000_003,), generator=g, device=d),
    "all-equal": lambda g, d: torch.full((70_001,), 9, dtype=torch.int64, device=d),
    "three-passes-int32": lambda g, d: torch.randint(0, 1 << 20, (2_000_000,), generator=g, device=d,
                                                     dtype=torch.int32) * 11,
    "wide-int64": lambda g, d: torch.randint(-(1 << 40), 1 << 40, (300_000,), generator=g, device=d) // 1000,
    "one-key": lambda g, d: torch.tensor([5], device=d),
}


@pytest.mark.parametrize("case", sorted(RANK_CASES))
def test_radix_kernel_matches_plain(dev, gen, case):
    keys = RANK_CASES[case](gen, dev)
    before = _build.launch_counts()["radix_rank"]
    rank = radix_rank(keys)
    perm = radix_argsort(keys)
    assert _build.launch_counts()["radix_rank"] == before + 2
    assert torch.equal(rank, radix_rank_plain(keys))
    assert torch.equal(perm, radix_argsort_plain(keys))


def single_zero_among_negatives(g, d, dtype):
    keys = -torch.randint(1, 40, (100_000,), generator=g, device=d)
    keys[77_777] = 0
    return keys.to(dtype)


def packed_pairs(g, d, n, nseg, ncols):
    return (torch.randint(0, nseg, (n,), generator=g, device=d) << 32) | torch.randint(0, ncols, (n,), generator=g,
                                                                                        device=d)


# name -> (keys made on the card, what the caller states of their bits)
RANK_EDGE_CASES = {
    "stated-wider-than-the-data": lambda g, d: (torch.randint(0, 40, (1_000_003,), generator=g, device=d), 27),
    "all-equal-stated": lambda g, d: (torch.full((70_001,), 9, dtype=torch.int64, device=d), 27),
    "all-zero-no-bits": lambda g, d: (torch.zeros((5_000,), dtype=torch.int32, device=d), 0),
    "nothing-stated-int64": lambda g, d: (torch.randint(0, 1 << 20, (500_000,), generator=g, device=d), None),
    "single-zero-among-negatives": lambda g, d: (single_zero_among_negatives(g, d, torch.int64), None),
    "single-zero-among-negatives-int32": lambda g, d: (single_zero_among_negatives(g, d, torch.int32), None),
    "int16-keys": lambda g, d: (torch.randint(-300, 300, (100_000,), generator=g, device=d).to(torch.int16), None),
    "uint8-keys": lambda g, d: (torch.randint(0, 256, (100_000,), generator=g, device=d).to(torch.uint8), None),
    "tile-exactly": lambda g, d: (torch.randint(0, 1 << 12, (4_096,), generator=g, device=d), 12),
    "tile-and-one": lambda g, d: (torch.randint(0, 1 << 12, (4_097,), generator=g, device=d), 12),
    "3000-tiles": lambda g, d: (torch.randint(0, 1 << 24, (3_000 * 4_096 + 5,), generator=g, device=d,
                                              dtype=torch.int32), 24),
    "off-alignment": lambda g, d: (off_alignment(torch.randint(0, 1 << 16, (100_001,), generator=g, device=d,
                                                               dtype=torch.int32)), 16),
    "packed-pairs": lambda g, d: (packed_pairs(g, d, 3_000_000, 5_000, 70_000), [(0, 17), (32, 45)]),
    "packed-pairs-wide-statement": lambda g, d: (packed_pairs(g, d, 300_000, 37, 200), [(0, 23), (32, 55)]),
    "mask-minus-degrees": lambda g, d: ((1 << 27) - 1 - path_a_degrees(g, d, 500_000), 27),
}


@pytest.mark.parametrize("case", sorted(RANK_EDGE_CASES))
def test_radix_kernel_edges_match_plain(dev, gen, case):
    keys, key_bits = RANK_EDGE_CASES[case](gen, dev)
    before = _build.launch_counts()["radix_rank"]
    rank = radix_rank(keys, key_bits)
    perm, sorted_keys = radix_argsort(keys, key_bits, return_keys=True)
    assert _build.launch_counts()["radix_rank"] == before + 2
    assert torch.equal(rank, radix_rank_plain(keys))
    assert torch.equal(perm, radix_argsort_plain(keys))
    assert sorted_keys.dtype == keys.dtype and torch.equal(sorted_keys, torch.sort(keys, stable=True).values)


def test_radix_unique_on_the_card(dev, gen):
    """``radix_unique`` launches K5 once and gives ``torch.unique``'s keys."""
    from sparsebase_tpu_torch.ops.kernels.radix import bits_below, radix_unique

    keys = torch.randint(0, 1 << 20, (300_000,), generator=gen, device=dev)
    before = _build.launch_counts()["radix_rank"]
    got = radix_unique(keys, key_bits=bits_below(1 << 20))
    assert _build.launch_counts()["radix_rank"] == before + 1
    assert torch.equal(got, torch.unique(keys))


def count_syncs(fn):
    """Synchronising CUDA operations in one call of ``fn``."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)], result


@pytest.mark.parametrize("stated", [False, True], ids=["nothing-stated", "bits-stated"])
def test_radix_makes_no_host_sync(dev, gen, stated):
    """One call of ``radix_rank`` or ``radix_argsort`` reads nothing back."""
    keys = path_a_degrees(gen, dev, 200_000)
    key_bits = 27 if stated else None
    radix_rank(keys, key_bits)  # builds and loads the kernels
    for call in (lambda: radix_rank(keys, key_bits), lambda: radix_argsort(keys, key_bits),
                 lambda: radix_argsort(keys, key_bits, return_keys=True)):
        syncs, _ = count_syncs(call)
        assert not syncs, [str(w.message) for w in syncs]
    assert torch.equal(radix_rank(keys, key_bits), radix_rank_plain(keys))


@pytest.mark.parametrize("bounds", [False, True], ids=["no-bounds", "bounds-stated"])
def test_sort_by_pairs_on_card_is_the_stable_sort(dev, gen, bounds):
    """The (major, minor) sort through K5 equals one stable ``torch.sort``
    of the packed key bit for bit: duplicates keep their input order."""
    n = 1_000_000
    major = torch.randint(0, 3_000, (n,), generator=gen, device=dev, dtype=torch.int32)
    minor = torch.randint(0, 500, (n,), generator=gen, device=dev, dtype=torch.int32)
    payload = torch.randn((n,), generator=gen, device=dev)
    before = _build.launch_counts()["radix_rank"]
    kwargs = dict(major_bound=3_000, minor_bound=500) if bounds else {}
    got = sort_by_pairs(major, minor, payload, None, **kwargs)
    assert _build.launch_counts()["radix_rank"] == before + 1
    want = sort_by_pairs_plain(major, minor, payload, None)
    assert got[3] is None
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    coo = COO.new(major, minor, payload, (3_000, 500))
    assert coo.is_sorted() and torch.equal(coo.vals, want[2])


def device_csr(gen, dev, degrees, ncols, pattern=False, dtype=torch.float32, misaligned=False):
    """A CSR with the given row degrees, 20 copies of one coordinate in the
    first row of at least 20 entries (if any), and columns unsorted inside
    rows; with ``misaligned``, ids and values start one element past a
    16-byte boundary."""
    degrees = degrees.to(dev)
    indptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), degrees.cumsum(0)])
    nnz = int(indptr[-1])
    cols = torch.randint(0, ncols, (nnz,), generator=gen, device=dev, dtype=torch.int32)
    big = torch.nonzero(degrees >= 20)
    if big.numel():
        first = int(indptr[int(big[0])])
        cols[first:first + 20] = cols[first]
    vals = None if pattern else torch.randn((nnz,), generator=gen, device=dev).to(dtype)
    if misaligned:  # K4's scalar loads
        cols = off_alignment(cols)
        vals = None if pattern else off_alignment(vals)
    return CSR(indptr, cols, vals, (degrees.numel(), ncols))


def degrees_mix(gen, dev, n, long_row=None):
    """Degrees over the warp tier (<= 32) and the block tier (<= 4096),
    empty rows, and optionally one row over the cap."""
    deg = torch.randint(0, 40, (n,), generator=gen, device=dev)
    deg[::7] = 0
    deg[5::97] = torch.randint(33, 4097, (deg[5::97].numel(),), generator=gen, device=dev)
    if long_row is not None:
        deg[n // 2] = long_row
    return deg


def degrees_set(gen, dev, n, at, lo, hi=None):
    """``degrees_mix`` with the rows ``at`` (a slice) set to ``lo`` entries,
    or drawn from [lo, hi]."""
    deg = degrees_mix(gen, dev, n)
    k = deg[at].numel()
    deg[at] = lo if hi is None else torch.randint(lo, hi + 1, (k,), generator=gen, device=dev)
    return deg


def path_a_degrees(gen, dev, n):
    return torch.poisson(torch.full((n,), 16.0, device=dev), generator=gen).to(torch.int64)


# name -> (row degrees, rows permuted, columns relabelled, pattern, value dtype,
# ids and values off 16-byte alignment). K4's warp tier takes groups of 32
# rows and stages the rows of up to 32 entries.
RELOCATE_CASES = {
    "rows-only": (lambda g, d: degrees_mix(g, d, 50_000), True, False, False, torch.float32, False),
    "cols-only": (lambda g, d: degrees_mix(g, d, 50_000), False, True, False, torch.float32, False),
    "both-nonsymmetric": (lambda g, d: degrees_mix(g, d, 50_000), True, True, False, torch.float32, False),
    "sort-only": (lambda g, d: degrees_mix(g, d, 50_000), False, False, False, torch.float32, False),
    "pattern": (lambda g, d: degrees_mix(g, d, 50_000), True, True, True, torch.float32, False),
    "float64-values": (lambda g, d: degrees_mix(g, d, 50_000), True, True, False, torch.float64, False),
    "row-of-5000": (lambda g, d: degrees_mix(g, d, 20_000, 5_000), True, True, False, torch.float32, False),
    "row-of-262144": (lambda g, d: degrees_mix(g, d, 20_000, 262_144), True, True, False, torch.float32, False),
    "rows-of-32-and-33": (lambda g, d: degrees_set(g, d, 20_000, slice(0, None, 2), 32, 33), True, True, False,
                          torch.float32, False),
    "group-of-empty-rows": (lambda g, d: degrees_set(g, d, 20_000, slice(64, 96), 0), True, True, False,
                            torch.float32, False),
    "group-in-block-tier": (lambda g, d: degrees_set(g, d, 20_000, slice(96, 128), 33, 4_096), True, True, False,
                            torch.float32, False),
    "one-row": (lambda g, d: torch.tensor([25], device=d), True, True, False, torch.float32, False),
    "n-not-multiple-of-32": (lambda g, d: path_a_degrees(g, d, 100_003), True, True, False, torch.float32, False),
    "ids-off-alignment": (lambda g, d: path_a_degrees(g, d, 50_000), True, True, False, torch.float32, True),
    "ids-off-alignment-pattern": (lambda g, d: degrees_mix(g, d, 50_000), True, True, True, torch.float32, True),
    "column-table-of-2^24": (lambda g, d: path_a_degrees(g, d, 200_000), True, True, False, torch.float32, False),
}
RELOCATE_NCOLS = {"column-table-of-2^24": 1 << 24}  # columns of the cases that are not 30,000 wide


@pytest.mark.parametrize("case", sorted(RELOCATE_CASES))
def test_relocate_kernel_matches_plain(dev, gen, case):
    degrees, rows, cols, pattern, dtype, misaligned = RELOCATE_CASES[case]
    ncols = RELOCATE_NCOLS.get(case, 30_000)
    csr = device_csr(gen, dev, degrees(gen, dev), ncols, pattern, dtype, misaligned)
    n = csr.nrows
    ro = torch.randperm(n, generator=gen, device=dev).to(torch.int32) if rows else None
    co = torch.randperm(ncols, generator=gen, device=dev).to(torch.int32) if cols else None
    before = _build.launch_counts()["relocate_csr"]
    got = relocate_csr(csr, ro, co)
    assert _build.launch_counts()["relocate_csr"] == before + 1
    want = relocate_csr_plain(csr, ro, co)
    assert torch.equal(got.indptr, want.indptr)
    assert torch.equal(got.indices, want.indices)
    if pattern:
        assert got.vals is None
    else:
        assert got.vals.dtype == dtype and torch.equal(got.vals, want.vals)


def test_relocate_rejects_orders_of_the_wrong_length(dev, gen):
    csr = device_csr(gen, dev, degrees_mix(gen, dev, 1_000), 500)
    with pytest.raises(ValueError):
        relocate_csr(csr, torch.arange(999, dtype=torch.int32, device=dev), None)
    with pytest.raises(ValueError):
        relocate_csr(csr, None, torch.arange(400, dtype=torch.int32, device=dev))


def test_relocate_syncs_the_host_once(dev, gen):
    """On path A's degrees (none over BLOCK_MAX) a call reads one number
    back: how many rows are over BLOCK_MAX."""
    n = 200_000
    csr = device_csr(gen, dev, path_a_degrees(gen, dev, n), n)
    ro = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    co = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    relocate_csr(csr, ro, co)  # builds and loads the kernels
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = relocate_csr(csr, ro, co)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in syncs]
    assert torch.equal(got.indices, relocate_csr_plain(csr, ro, co).indices)


def long_row_csr(gen, dev):
    """``degrees_mix`` with five rows of 4,097 to 9,000 entries, past K4's
    block tier, and its two orders."""
    deg = degrees_set(gen, dev, 20_000, slice(1_000, 1_005), 4_097, 9_000)
    csr = device_csr(gen, dev, deg, 30_000)
    ro = torch.randperm(csr.nrows, generator=gen, device=dev).to(torch.int32)
    co = torch.randperm(30_000, generator=gen, device=dev).to(torch.int32)
    return deg, csr, ro, co


def test_relocate_counts_the_rows_over_block_max(dev, gen):
    """The long-row route's counters equal what the host computes from the
    degrees: the call's entries, the rows over BLOCK_MAX and theirs."""
    from sparsebase_tpu_torch.ops.kernels.relocate import BLOCK_MAX
    from sparsebase_tpu_torch.utils import tracing

    deg, csr, ro, co = long_row_csr(gen, dev)
    names = ("relocate.entries", "relocate.long_rows", "relocate.long_row_entries")
    before = tracing.counters()
    got = relocate_csr(csr, ro, co)
    after = tracing.counters()
    over = deg > BLOCK_MAX
    want = (int(deg.sum()), int(over.sum()), int(deg[over].sum()))
    assert want[1] == 5
    assert tuple(after.get(k, 0) - before.get(k, 0) for k in names) == want
    assert torch.equal(got.indices, relocate_csr_plain(csr, ro, co).indices)


def test_relocate_with_long_rows_syncs_twice_traced_or_not(dev, gen):
    """Rows over BLOCK_MAX: a call reads back how many there are and their
    total length, with or without a profiler running; traced, the route
    runs inside its span on the device."""
    from torch.profiler import ProfilerActivity, profile

    _, csr, ro, co = long_row_csr(gen, dev)
    relocate_csr(csr, ro, co)
    torch.cuda.synchronize()

    def syncs():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                relocate_csr(csr, ro, co)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)

    assert syncs() == 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        assert syncs() == 2
    device_spans = [ev for ev in prof.events() if ev.name == "sbtorch:relocate:long_rows"
                    and ev.device_type != torch.autograd.DeviceType.CPU]
    assert len(device_spans) == 1


def test_a_callers_span_keeps_the_conversions_device_time(dev):
    """The conversion's spans are host ranges: the caller's span around
    ``convert(DIA)`` holds the conversion's kernels on the device, and the
    stage spans have no device range of their own."""
    from torch.profiler import ProfilerActivity, profile, record_function

    n = 50_000
    i = torch.arange(n, device=dev)
    row = torch.cat([i, i[1:], i[:-1]]).to(torch.int32)
    col = torch.cat([i, i[1:] - 1, i[:-1] + 1]).to(torch.int32)
    row, col, vals = sort_by_pairs_plain(row, col, torch.ones(row.numel(), device=dev))
    csr = COO(row, col, vals, (n, n)).convert(CSR)
    csr.convert(DIA)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("caller"):
            dia = csr.convert(DIA)
        torch.cuda.synchronize()
    on_device = {ev.name for ev in prof.events() if ev.device_type != torch.autograd.DeviceType.CPU}
    on_host = {ev.name for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CPU}
    assert "caller" in on_device and not any(name.startswith("sbtorch:") for name in on_device)
    assert {"sbtorch:convert:CSR->DIA", "sbtorch:csr_to_dia:offsets", "sbtorch:csr_to_dia:fill"} <= on_host
    assert dia.offsets.tolist() == [-1, 0, 1]


def stencil27_coo(gen, dev, nx):
    """HPCG's 27-point stencil on an ``nx``³ grid, rows in order and the
    columns of each ascending, random values with every 97th a -0.0."""
    n = nx ** 3
    r = torch.arange(n, device=dev)
    s = torch.arange(-1, 2, device=dev)
    sz, sy, sx = (a.reshape(-1) for a in torch.meshgrid(s, s, s, indexing="ij"))
    ok = torch.ones((n, 27), dtype=torch.bool, device=dev)
    for i, sh in ((r % nx, sx), ((r // nx) % nx, sy), (r // (nx * nx), sz)):
        ok &= ((i[:, None] + sh) >= 0) & ((i[:, None] + sh) < nx)
    row = r[:, None].expand(-1, 27)[ok].to(torch.int32)
    col = (r[:, None] + sz * nx * nx + sy * nx + sx)[ok].to(torch.int32)
    vals = torch.randn((row.numel(),), generator=gen, device=dev)
    vals[::97] = -0.0
    return COO(row, col, vals, (n, n))


def accumulated_band(csr):
    """The band as one accumulating ``index_put_`` fills it."""
    row = csr.row_of_nnz()
    off = csr.indices.to(torch.int32) - row.to(torch.int32)
    offsets = torch.unique(off)
    data = torch.zeros((offsets.numel(), csr.nrows), dtype=csr.vals.dtype, device=csr.vals.device)
    data.index_put_((torch.searchsorted(offsets, off), row.long()), csr.vals, accumulate=True)
    return offsets, data


def test_csr_to_dia_routes_on_card(dev, gen):
    """A 27-point band at 1M rows, every row strictly ascending, takes the
    scatter route: its band equals the accumulating expression bit for bit,
    the signs of its zeros too, and ``convert(DIA)`` syncs the host once.
    With repeated coordinates the band takes the accumulate route and gives
    the same band as that expression."""
    from sparsebase_tpu_torch.utils import tracing

    coo = stencil27_coo(gen, dev, 100)
    csr = coo.convert(CSR)
    csr.convert(DIA)
    before = tracing.counters()
    syncs, dia = count_syncs(lambda: csr.convert(DIA))
    after = tracing.counters()
    assert len(syncs) == 1, [str(w.message) for w in syncs]
    assert after.get("csr_to_dia.scatter", 0) == before.get("csr_to_dia.scatter", 0) + 1
    assert after.get("csr_to_dia.accumulate", 0) == before.get("csr_to_dia.accumulate", 0)
    offsets, want = accumulated_band(csr)
    assert dia.num_diagonals == 27 and torch.equal(dia.offsets, offsets)
    assert torch.equal(dia.data, want) and torch.equal(torch.signbit(dia.data), torch.signbit(want))

    pick = torch.arange(0, coo.nnz, 1_000, device=dev)  # every 1,000th entry once more, another value
    extra = torch.randn((pick.numel(),), generator=gen, device=dev)
    row, col, vals = sort_by_pairs_plain(torch.cat([coo.row, coo.row[pick]]), torch.cat([coo.col, coo.col[pick]]),
                                         torch.cat([coo.vals, extra]))
    twice = COO(row, col, vals, coo.shape).convert(CSR)
    before = tracing.counters()
    dia = twice.convert(DIA)
    after = tracing.counters()
    assert after.get("csr_to_dia.accumulate", 0) == before.get("csr_to_dia.accumulate", 0) + 1
    offsets, want = accumulated_band(twice)
    assert torch.equal(dia.offsets, offsets)
    assert torch.equal(dia.data, want) and torch.equal(torch.signbit(dia.data), torch.signbit(want))


def small_graph(gen, dev, n=20_000, nnz=300_000):
    row = torch.randint(0, n, (nnz,), generator=gen, device=dev, dtype=torch.int32)
    col = torch.randint(0, n, (nnz,), generator=gen, device=dev, dtype=torch.int32)
    vals = torch.randint(-5, 6, (nnz,), generator=gen, device=dev).to(torch.float32)  # exact in every value type
    return sort_by_pairs_plain(row, col, vals)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float64, torch.int32, torch.int8],
                         ids=["bf16", "f16", "f64", "int32", "int8"])
def test_spmv_and_pipeline_take_any_value_dtype(dev, gen, dtype):
    """K2 casts values of any type to float32 and launches; the pipeline
    runs on them, the permuted matrix keeping the caller's value type."""
    n = 20_000
    row, col, vals = small_graph(gen, dev, n)
    x = torch.randn((n,), generator=gen, device=dev)
    coo = COO(row, col, vals.to(dtype), (n, n))
    want_permuted, want_y = preprocess_pipeline(COO(row, col, vals, (n, n)), x)
    before = _build.launch_counts()
    y = spmv(coo.convert(CSR), x)
    permuted, y_p = preprocess_pipeline(coo, x)
    after = _build.launch_counts()
    assert after["csr_spmv"] == before["csr_spmv"] + 2
    assert after["relocate_csr"] == before["relocate_csr"] + 1
    assert y.dtype == torch.float32 and torch.equal(y_p, want_y)
    assert permuted.vals.dtype == dtype
    assert torch.equal(permuted.indices, want_permuted.indices)
    assert torch.equal(permuted.vals.to(torch.float32), want_permuted.vals)


def test_spmv_on_card_needs_float32_x(dev, gen):
    n = 2_000
    row, col, vals = small_graph(gen, dev, n, 30_000)
    csr = COO(row, col, vals, (n, n)).convert(CSR)
    for dtype in (torch.float64, torch.bfloat16):
        with pytest.raises(TypeMismatchError, match="float32"):
            csr_spmv(csr, torch.zeros((n,), dtype=dtype, device=dev))


@pytest.mark.parametrize("id_dtype", [torch.int16, torch.int32, torch.int64], ids=["int16", "int32", "int64"])
@pytest.mark.parametrize("offset_dtype", [torch.int32, torch.int64], ids=["offsets32", "offsets64"])
def test_wrappers_take_any_index_dtype_on_card(dev, gen, id_dtype, offset_dtype):
    """``convert(CSR)`` (K3), ``spmv`` (K2) and ``permute_2d`` (K4) on ids
    and offsets of other integer types: each launches its kernel, gives what
    int32 ids and int64 offsets give, and hands ids back in the caller's type."""
    n = 20_000
    row, col, vals = small_graph(gen, dev, n)
    x = torch.randn((n,), generator=gen, device=dev)
    ro = torch.randperm(n, generator=gen, device=dev)
    co = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    base = COO(row, col, vals, (n, n)).convert(CSR)
    want_y, want = csr_spmv(base, x), relocate_csr(base, ro, co)
    before = _build.launch_counts()
    csr = COO(row.to(id_dtype), col.to(id_dtype), vals, (n, n)).convert(CSR)
    assert csr.indptr.dtype == torch.int64 and torch.equal(csr.indptr, base.indptr)
    csr = CSR(csr.indptr.to(offset_dtype), csr.indices, csr.vals, csr.shape)
    y = spmv(csr, x)
    got = permute_2d(csr, ro, co)
    after = _build.launch_counts()
    for kernel in ("indptr", "csr_spmv", "relocate_csr"):
        assert after[kernel] == before[kernel] + 1, kernel
    assert torch.equal(y, want_y)
    assert got.indices.dtype == id_dtype and torch.equal(got.indices.to(torch.int32), want.indices)
    assert torch.equal(got.indptr, want.indptr) and torch.equal(got.vals, want.vals)
    sorted_only = CSR.new(csr.indptr, torch.flip(csr.indices, (0,)), csr.vals, csr.shape)  # repaired through K4
    assert sorted_only.indices.dtype == id_dtype and sorted_only.is_sorted()


def test_wrappers_raise_on_ids_past_int32(dev):
    big = torch.tensor([0, 2**31], dtype=torch.int64, device=dev)
    with pytest.raises(TypeMismatchError):
        indptr_from_sorted_rows(big, 5)
    csr = CSR(torch.tensor([0, 2], dtype=torch.int64, device=dev), big, None, (1, 2**31 + 1))
    with pytest.raises(TypeMismatchError):
        relocate_csr(csr)


def test_relocate_long_rows_add_one_sync_and_one_k5_launch(dev, gen):
    """Rows over BLOCK_MAX go through K5 with their live bits stated: K5
    launches once and reads nothing back; the route itself reads the rows'
    total length, so the call syncs twice."""
    csr = device_csr(gen, dev, degrees_mix(gen, dev, 20_000, 262_144), 30_000)
    ro = torch.randperm(csr.nrows, generator=gen, device=dev).to(torch.int32)
    co = torch.randperm(30_000, generator=gen, device=dev).to(torch.int32)
    relocate_csr(csr, ro, co)
    before = _build.launch_counts()["radix_rank"]
    syncs, got = count_syncs(lambda: relocate_csr(csr, ro, co))
    assert _build.launch_counts()["radix_rank"] == before + 1
    assert len(syncs) == 2, [str(w.message) for w in syncs]
    want = relocate_csr_plain(csr, ro, co)
    assert torch.equal(got.indices, want.indices) and torch.equal(got.vals, want.vals)


# -- RCM and the formats of slice 7 ------------------------------------------------


def pattern_csr(row, col, n, dev):
    """The row-major-sorted pattern CSR of the (row, col) pairs, on ``dev``."""
    row, col, _ = sort_by_pairs_plain(row.to(torch.int32), col.to(torch.int32), None)
    return COO(row, col, None, (n, n)).to_device(dev).convert(CSR)


def scrambled(row, col, n, gen):
    perm = torch.randperm(n, generator=gen)
    return perm[row], perm[col]


def rcm_graph(name, gen):
    """Symmetric test graphs, made on the CPU from a seed: (row, col, n)."""
    both = lambda r, c: (torch.cat([r, c]), torch.cat([c, r]))  # noqa: E731
    if name == "scrambled-tridiagonal-64":
        i = torch.arange(63)
        return (*scrambled(*both(i, i + 1), 64, gen), 64)
    if name == "random-48":
        return (*both(torch.randint(0, 48, (240,), generator=gen), torch.randint(0, 48, (240,), generator=gen)), 48)
    if name == "path-1024":
        i = torch.arange(1023)
        return (*both(i, i + 1), 1024)
    if name == "vertex-0-isolated":
        r, c = torch.randint(5, 60, (90,), generator=gen), torch.randint(5, 60, (90,), generator=gen)
        return (*both(r, c), 60)
    # several components and six isolated vertices, scrambled
    rows, cols, base = [], [], 0
    for size, edges in ((30, 50), (12, 15), (20, 25)):
        r, c = both(torch.randint(0, size, (edges,), generator=gen), torch.randint(0, size, (edges,), generator=gen))
        rows.append(r + base)
        cols.append(c + base)
        base += size
    return (*scrambled(torch.cat(rows), torch.cat(cols), base + 6, gen), base + 6)


RCM_GRAPHS = ["scrambled-tridiagonal-64", "random-48", "path-1024", "vertex-0-isolated", "components"]


@pytest.mark.parametrize("symmetrize", [True, False], ids=["symmetrized", "out-edges"])
@pytest.mark.parametrize("name", RCM_GRAPHS)
def test_rcm_device_route_on_card_equals_cpu(dev, name, symmetrize):
    from sparsebase_tpu_torch.ops.reorder.rcm import _rcm_device, _symmetrized_square

    row, col, n = rcm_graph(name, torch.Generator().manual_seed(0))
    csr = pattern_csr(row, col, n, dev)
    if symmetrize:
        csr = _symmetrized_square(csr)
    got = _rcm_device(csr)
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got.cpu(), _rcm_device(csr.to_host()))


@pytest.mark.parametrize("name", ["components", "path-1024"])
def test_rcm_device_route_by_two_sorts_on_card_equals_cpu(dev, name, monkeypatch):
    """Where (run, degree, id) do not fit one key, the two stable argsorts
    rank each level on the card, with the packed key's order."""
    from sparsebase_tpu_torch.ops.reorder import rcm

    row, col, n = rcm_graph(name, torch.Generator().manual_seed(0))
    csr = rcm._symmetrized_square(pattern_csr(row, col, n, dev))
    packed = rcm._rcm_device(csr.to_host())
    monkeypatch.setattr(rcm, "_KEY_BITS", 8)
    got = rcm._rcm_device(csr)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), packed)


@pytest.mark.parametrize("shape", [(20_000, 20_000), (8_000, 30_000), (30_000, 8_000)], ids=["square", "wide", "tall"])
def test_symmetrized_square_and_csc_transposes_on_card(dev, gen, shape):
    """K5 sorts and K3 offsets give the CPU route's arrays bit for bit."""
    from sparsebase_tpu_torch import CSC
    from sparsebase_tpu_torch.ops.reorder import RCMReorder
    from sparsebase_tpu_torch.ops.reorder.rcm import _symmetrized_square

    n, m = shape
    row = torch.randint(0, n, (200_000,), generator=gen, device=dev, dtype=torch.int32)
    col = torch.randint(0, m, (200_000,), generator=gen, device=dev, dtype=torch.int32)
    coo = COO.new(row, col, torch.randn((200_000,), generator=gen, device=dev), shape)
    csr = coo.convert(CSR)
    before = _build.launch_counts()["radix_rank"]
    sym = _symmetrized_square(csr)
    assert _build.launch_counts()["radix_rank"] == before + 1
    cpu_sym = _symmetrized_square(csr.to_host())
    assert torch.equal(sym.indptr.cpu(), cpu_sym.indptr) and torch.equal(sym.indices.cpu(), cpu_sym.indices)
    for got, want in ((csr.convert(CSC), csr.to_host().convert(CSC)), (coo.convert(CSC), coo.to_host().convert(CSC)),
                      (csr.convert(CSC).convert(CSR), csr.to_host()),
                      (coo.convert(CSC).convert(COO), coo.to_host())):
        for a, b in zip(got._tensors(), want._tensors()):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
    order = RCMReorder().get_reorder(csr)
    assert order.device.type == "cuda" and order.shape == (n,)
    assert torch.equal(torch.sort(order.long()).values.cpu(), torch.arange(n))


def test_ell_round_trip_and_spmv_on_card(dev, gen):
    from sparsebase_tpu_torch import ELL
    from sparsebase_tpu_torch.ops.permute import permute_2d

    n = 50_000
    csr = device_csr(gen, dev, path_a_degrees(gen, dev, n), n)
    ell = csr.convert(ELL)
    assert ell.cols.device.type == "cuda" and ell.width == int(csr.degrees().max())
    back = ell.convert(CSR)
    for field in ("indptr", "indices", "vals"):
        assert torch.equal(getattr(back, field), getattr(csr, field)), field
    x = torch.randn((n,), generator=gen, device=dev)
    absdot = csr_spmv_plain(CSR(csr.indptr, csr.indices, csr.vals.abs(), csr.shape), x.abs())
    assert_rows_within(spmv(ell, x), csr_spmv(csr, x), csr.degrees(), absdot)
    ro = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    co = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    got = permute_2d(ell, ro, co).convert(CSR)
    want = relocate_csr_plain(csr, ro, co)
    for field in ("indptr", "indices", "vals"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field


def test_rcm_syncs_the_host_at_most_once_per_level_step(dev):
    """On a path graph of 1,024 vertices (about 1,024 levels per sweep)."""
    from sparsebase_tpu_torch.ops.reorder import RCMReorder
    from sparsebase_tpu_torch.ops.reorder.rcm import _rcm_device, _symmetrized_square

    row, col, n = rcm_graph("path-1024", None)
    csr = pattern_csr(row, col, n, dev)
    stats = {}
    _rcm_device(_symmetrized_square(csr), stats=stats)
    assert stats["level_steps"] >= 3 * 1_000
    RCMReorder().get_reorder(csr)  # builds and loads the kernels
    syncs, order = count_syncs(lambda: RCMReorder().get_reorder(csr))
    assert 0 < len(syncs) <= stats["level_steps"]
    assert torch.equal(order.cpu(), _rcm_device(_symmetrized_square(csr.to_host())))


def test_rcm_pipeline_on_card_matches_cpu(dev, gen):
    from sparsebase_tpu_torch import rcm_pipeline

    n, nnz = 5_000, 60_000
    row = torch.randint(0, n, (nnz,), generator=gen, device=dev, dtype=torch.int32)
    col = torch.randint(0, n, (nnz,), generator=gen, device=dev, dtype=torch.int32)
    coo = COO.new(row, col, torch.randn((nnz,), generator=gen, device=dev), (n, n))
    x = torch.randn((n,), generator=gen, device=dev)
    before = _build.launch_counts()
    permuted, y = rcm_pipeline(coo, x)
    after = _build.launch_counts()
    assert all(after[k] > before[k] for k in ("indptr", "relocate_csr", "csr_spmv"))
    cpu_permuted, cpu_y = rcm_pipeline(coo.to_host(), x.cpu())
    for field in ("indptr", "indices", "vals"):
        assert torch.equal(getattr(permuted, field).cpu(), getattr(cpu_permuted, field)), field
    torch.testing.assert_close(y.cpu(), cpu_y, rtol=1e-5, atol=1e-5)


# -- slice 8: readers on the card, donation -------------------------------------------


def write_symmetric_mtx(path, gen, dev, n=3_000, nnz=40_000):
    from sparsebase_tpu_torch import IOBase

    row = torch.randint(0, n, (nnz,), generator=gen, device=dev, dtype=torch.int32)
    col = torch.randint(0, n, (nnz,), generator=gen, device=dev, dtype=torch.int32)
    coo = COO.new(row, col, torch.randn((nnz,), generator=gen, device=dev), (n, n))
    IOBase.write_coo_to_mtx(coo, str(path), symmetry="symmetric")
    return str(path)


def test_host_libraries_build_on_the_card_machine():
    from sparsebase_tpu_torch import native
    from sparsebase_tpu_torch.io import fastio

    assert fastio.available() and native.available()


def test_readers_place_on_the_card_by_default(tmp_path, dev, gen):
    from sparsebase_tpu_torch import Graph, IOBase

    p = write_symmetric_mtx(tmp_path / "m.mtx", gen, dev)
    for fmt in (IOBase.read_mtx_to_coo(p), IOBase.read_pigo_mtx_to_coo(p),
                Graph.read_connectivity_from_mtx_to_coo(p).connectivity):
        assert fmt.row.device.type == "cuda" and fmt.col.device.type == "cuda" and fmt.vals.device.type == "cuda"
    csr = IOBase.read_pigo_mtx_to_csr(p)
    IOBase.write_csr_to_binary(csr, str(tmp_path / "m.sbff"))
    assert IOBase.read_binary_to_csr(str(tmp_path / "m.sbff")).indptr.device.type == "cuda"


def test_pigo_reader_on_card_equals_cpu_reader(tmp_path, dev, gen):
    from sparsebase_tpu_torch.io import MTXReader, PigoMTXReader

    p = write_symmetric_mtx(tmp_path / "m.mtx", gen, dev)
    before = _build.launch_counts()["radix_rank"]
    card = PigoMTXReader(p).read_coo()
    assert _build.launch_counts()["radix_rank"] == before + 1  # the mirrored entries sorted by K5
    for cpu in (PigoMTXReader(p, device="cpu").read_coo(), MTXReader(p, device="cpu").read_coo()):
        for field in ("row", "col", "vals"):
            assert torch.equal(getattr(card, field).cpu(), getattr(cpu, field)), field


def test_donation_lowers_peak_memory_by_the_row_ids(dev, gen):
    from sparsebase_tpu_torch import preprocess_pipeline_donating

    n, nnz = 200_000, 4_000_000
    row = torch.randint(0, n, (nnz,), generator=gen, device=dev, dtype=torch.int32)
    col = torch.randint(0, n, (nnz,), generator=gen, device=dev, dtype=torch.int32)
    coo = COO.new(row, col, torch.randn((nnz,), generator=gen, device=dev), (n, n))
    del row, col
    x = torch.randn((n,), generator=gen, device=dev)
    preprocess_pipeline(coo, x)  # builds and loads the kernels

    def peak(fn):
        clone = COO(coo.row.clone(), coo.col.clone(), coo.vals.clone(), coo.shape)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(clone, x)
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    (plain_csr, plain_y), plain_peak = peak(preprocess_pipeline)
    (don_csr, don_y), donating_peak = peak(preprocess_pipeline_donating)
    assert plain_peak - donating_peak >= coo.row.numel() * coo.row.element_size()
    for field in ("indptr", "indices", "vals"):
        assert torch.equal(getattr(don_csr, field), getattr(plain_csr, field)), field
    assert torch.equal(don_y, plain_y)


# -- K6: common neighbours (Jaccard weights, triangle sums) -------------------------
def k6_graph(gen, dev, n, avg_deg, *, mirror=True, loops=0, dup_share=0, hub=0, ids_off_alignment=False, hubs=(),
             exact=(), ncols=None):
    """A random pattern through ``COO.new`` and ``convert(CSR)`` (K5, K3):
    ``n * avg_deg // 2`` uniform pairs with u != v, mirrored; ``loops``
    self-loops; the first ``dup_share`` of the entries again; row 0 a hub of
    ``hub`` distinct columns (mirrored with the rest). ``hubs``: rows 1, 2,
    ... get that many distinct columns each, drawn from the first
    ``2 * max(hubs)`` ids (so the hubs are each other's neighbours), mirrored
    with the rest. ``exact``: the last ``len(exact)`` rows hold exactly that
    many distinct columns, added after the rest. ``ncols``: a rectangular
    pattern of that many columns, not mirrored."""
    wide = n if ncols is None else ncols
    m = n * avg_deg // 2
    row = torch.randint(0, n, (m,), generator=gen, device=dev)
    col = (row + torch.randint(1, max(n, 2), (m,), generator=gen, device=dev)) % wide
    if hub:
        spokes = torch.randperm(n - 1, generator=gen, device=dev)[:hub] + 1
        row, col = torch.cat([row, torch.zeros_like(spokes)]), torch.cat([col, spokes])
    for i, size in enumerate(hubs):
        spokes = torch.randperm(2 * max(hubs), generator=gen, device=dev)[:size]
        row, col = torch.cat([row, torch.full_like(spokes, i + 1)]), torch.cat([col, spokes])
    if mirror and ncols is None:
        row, col = torch.cat([row, col]), torch.cat([col, row])
    if loops:
        at = torch.randint(0, min(n, wide), (loops,), generator=gen, device=dev)
        row, col = torch.cat([row, at]), torch.cat([col, at])
    if dup_share:
        k = int(row.numel() * dup_share)
        row, col = torch.cat([row, row[:k]]), torch.cat([col, col[:k]])
    if exact:
        keep = row < n - len(exact)
        row, col = row[keep], col[keep]
        for i, size in enumerate(exact):
            picked = torch.randperm(wide, generator=gen, device=dev)[:size]
            row, col = torch.cat([row, torch.full_like(picked, n - len(exact) + i)]), torch.cat([col, picked])
    csr = COO.new(row.to(torch.int32), col.to(torch.int32), None, (n, wide)).convert(CSR)
    if ids_off_alignment:
        csr = CSR(csr.indptr, off_alignment(csr.indices), None, csr.shape)
    return csr


# K6's tier bounds (csrc/common_neighbors.cu::tier_of) and one past each
K6_TIER_EDGES = (1, 8, 9, 16, 17, 32, 33, 1_024, 1_025, 8_192, 8_193)

K6_CASES = {
    "no-entries": dict(n=1_000, avg_deg=0),
    "one-edge": dict(n=2, avg_deg=1, mirror=False),
    "one-edge-mirrored": dict(n=2, avg_deg=1),
    "self-loops": dict(n=20_000, avg_deg=8, loops=2_000),
    "duplicates": dict(n=20_000, avg_deg=8, dup_share=0.25, loops=100),
    "empty-rows": dict(n=200_000, avg_deg=1),
    "directed": dict(n=30_000, avg_deg=12, mirror=False),
    "hub-262144": dict(n=300_000, avg_deg=4, hub=262_144),
    "ids-off-alignment": dict(n=50_000, avg_deg=10, loops=50, dup_share=0.1, ids_off_alignment=True),
    "tier-edges": dict(n=40_000, avg_deg=6, mirror=False, loops=20, exact=K6_TIER_EDGES),
    "tier-edges-mirrored": dict(n=40_000, avg_deg=6, dup_share=0.05, exact=K6_TIER_EDGES),
    "two-adjacent-hubs": dict(n=100_000, avg_deg=4, loops=30, hubs=(40_000, 40_000)),
    "hubs-of-hubs": dict(n=200_000, avg_deg=6, dup_share=0.02, hubs=(30_000, 9_000, 8_193, 8_192, 20_000)),
    "rectangular": dict(n=60_000, avg_deg=12, dup_share=0.1, ncols=45_000, exact=(40, 2_000, 9_000)),
}


@pytest.mark.parametrize("mode", ["jaccard", "triangles", "directed"])
@pytest.mark.parametrize("case", sorted(K6_CASES))
def test_common_neighbors_kernel_matches_plain(dev, gen, case, mode):
    from sparsebase_tpu_torch.convert.kernels import csr_to_csc
    from sparsebase_tpu_torch.ops.kernels import common_neighbors, common_neighbors_plain

    csr = k6_graph(gen, dev, **K6_CASES[case])
    if mode == "directed" and csr.nrows != csr.ncols:
        with pytest.raises(ValueError):  # directed mode takes a square CSR only
            common_neighbors(csr, mode, csr_to_csc(csr))
        return
    csc = csr_to_csc(csr) if mode == "directed" else None
    before = _build.launch_counts()["common_neighbors"]
    got = common_neighbors(csr, mode, csc)
    assert _build.launch_counts()["common_neighbors"] == before + (1 if csr.nnz else 0)
    want = common_neighbors_plain(csr, mode, csc)
    assert got.dtype == want.dtype and got.shape == want.shape and got.device == csr.indices.device
    assert torch.equal(got, want)  # Jaccard bit for bit, the sums exactly
    assert torch.equal(common_neighbors(csr, mode, csc), got)  # two runs agree


@pytest.mark.parametrize("mode", ["jaccard", "triangles", "directed"])
def test_common_neighbors_counts_in_place_when_its_queue_is_full(dev, gen, mode, monkeypatch):
    """With a queue of one slot, the entries whose two lists are both long
    that do not fit are counted where they are met: the same result."""
    import importlib

    from sparsebase_tpu_torch.convert.kernels import csr_to_csc
    from sparsebase_tpu_torch.ops.kernels import common_neighbors, common_neighbors_plain

    cn = importlib.import_module("sparsebase_tpu_torch.ops.kernels.common_neighbors")
    csr = k6_graph(gen, dev, **K6_CASES["hubs-of-hubs"])
    csc = csr_to_csc(csr) if mode == "directed" else None
    monkeypatch.setattr(cn, "DEFER_MIN_SLOTS", 1)
    monkeypatch.setattr(cn, "DEFER_SLOTS_PER", csr.nnz + 1)
    assert torch.equal(common_neighbors(csr, mode, csc), common_neighbors_plain(csr, mode, csc))


@pytest.mark.parametrize("mode", ["jaccard", "triangles", "directed"])
def test_common_neighbors_makes_no_host_sync(dev, gen, mode):
    from sparsebase_tpu_torch.convert.kernels import csr_to_csc
    from sparsebase_tpu_torch.ops.kernels import common_neighbors, common_neighbors_plain

    csr = k6_graph(gen, dev, 100_000, 16, loops=100, dup_share=0.05, mirror=mode != "directed")
    csc = csr_to_csc(csr) if mode == "directed" else None
    common_neighbors(csr, mode, csc)  # builds and loads the kernels
    syncs, got = count_syncs(lambda: common_neighbors(csr, mode, csc))
    assert not syncs, [str(w.message) for w in syncs]
    assert torch.equal(got, common_neighbors_plain(csr, mode, csc))


def test_features_on_card_launch_k6_and_equal_the_cpu(dev, gen, monkeypatch):
    """On a CUDA CSR, JaccardWeights and the undirected TriangleCount launch K6
    and never its plain version; every reference feature equals the same
    feature on a CPU copy."""
    import importlib

    from sparsebase_tpu_torch import DenseArray, GraphFeatureBase
    from sparsebase_tpu_torch.ops import feature
    from sparsebase_tpu_torch.ops.kernels import common_neighbors as cn_fn

    cn = importlib.import_module("sparsebase_tpu_torch.ops.kernels.common_neighbors")
    csr = k6_graph(gen, dev, 50_000, 16, loops=64, dup_share=1 / 16)
    cn_fn(csr, "jaccard")  # builds and loads the kernels
    leaves = [c for c in feature.REFERENCE_FEATURES if not issubclass(c, feature.FusedFeature)]
    host = GraphFeatureBase.extract(leaves, csr.to_host())

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran on a CUDA CSR")

    monkeypatch.setattr(cn, "common_neighbors_plain", no_plain)
    before = _build.launch_counts()["common_neighbors"]
    card = GraphFeatureBase.extract(leaves, csr)
    assert _build.launch_counts()["common_neighbors"] == before + 2
    assert set(card) == set(host) == set(leaves)
    for cls in leaves:
        got, want = card[cls], host[cls]
        if isinstance(got, DenseArray):
            got, want = got.vals, want.vals
        if isinstance(got, torch.Tensor):
            assert got.device.type == "cuda", cls.__name__
            got = got.cpu()
        if cls.__name__ in ("MedianDegreeColumn", "StandardDeviationDegreeColumn",
                            "CoefficientOfVariationDegreeColumn", "GeometricAvgDegreeColumn"):
            assert float(got) == pytest.approx(float(want), rel=1e-12, abs=0), cls.__name__
        elif isinstance(got, torch.Tensor):
            assert torch.equal(got, want), cls.__name__
        else:
            assert got == want, cls.__name__


def test_triangle_tiers_on_card(dev, gen):
    """At 16,384 vertices, the dense wall, on graphs with self-loops and
    duplicates: undirected, the dense tier, K6 and graphkit agree; directed,
    the dense tier, K6's directed mode, the same pattern as 16,385 vertices
    (the route past the wall) and the CPU routes (graphkit, the torch host
    helpers) agree, self-loops ignored on every one; on the symmetric graph
    the directed count is twice the undirected. K_512 gives C(512, 3) on both
    tiers and twice that directed."""
    from sparsebase_tpu_torch import native
    from sparsebase_tpu_torch.ops.feature import TriangleCount
    from sparsebase_tpu_torch.ops.feature.sparse_common import (
        directed_triangle_count_sparse_device, triangle_count_sparse_device,
    )
    from sparsebase_tpu_torch.ops.feature.triangles import MAX_DEVICE_DENSE_N, _device_dense_count, _directed_count

    n = MAX_DEVICE_DENSE_N
    sym = k6_graph(gen, dev, n, 24, loops=2_000, dup_share=0.1)
    host = sym.to_host()
    k6 = triangle_count_sparse_device(sym)
    assert k6 == _device_dense_count(sym, False) == TriangleCount().get_triangle_count(sym)
    assert k6 == native.triangles(host.nrows, host.indptr, host.indices, False) > 0
    for csr, twice in ((sym, 2 * k6), (k6_graph(gen, dev, n, 24, mirror=False, loops=2_000, dup_share=0.1), None)):
        h = csr.to_host()
        want = TriangleCount(True).get_triangle_count(h)  # graphkit, on a copy without the self-loops
        assert want == _directed_count(h) > 0
        if twice is not None:
            assert want == twice
        past = CSR(torch.cat([csr.indptr, csr.indptr[-1:]]), csr.indices, None, (n + 1, n + 1))
        assert _device_dense_count(csr, True) == TriangleCount(True).get_triangle_count(csr) == want
        assert directed_triangle_count_sparse_device(csr) == TriangleCount(True).get_triangle_count(past) == want
    m = 512
    i = torch.arange(m, device=dev)
    row, col = i.repeat_interleave(m), i.repeat(m)
    keep = row != col
    k512 = COO.new(row[keep].to(torch.int32), col[keep].to(torch.int32), None, (m, m)).convert(CSR)
    want = m * (m - 1) * (m - 2) // 6
    assert triangle_count_sparse_device(k512) == want == _device_dense_count(k512, False)
    assert directed_triangle_count_sparse_device(k512) == 2 * want == _device_dense_count(k512, True)


def test_fill_in_of_a_card_csr(dev, gen):
    from sparsebase_tpu_torch import GraphFeatureBase

    n, half = 20_000, 16
    i = torch.arange(n, device=dev)[:, None]
    j = i + torch.arange(-half, half + 1, device=dev)[None, :]
    ok = (j >= 0) & (j < n)
    band = COO.new(i.expand_as(j)[ok].to(torch.int32), j[ok].to(torch.int32), None, (n, n)).convert(CSR)
    assert GraphFeatureBase.get_fill_in(band) == sum(min(k, half) + 1 for k in range(n))


@pytest.mark.parametrize("n", [4_096, 16_384, 16_385])
def test_more_columns_than_rows_raises_on_card(dev, n):
    """Fault 3.1 repaired: on both sides of the dense wall, a CUDA CSR whose
    ids name no row raises before any route reads it."""
    from sparsebase_tpu_torch.ops import feature

    indptr = torch.tensor([0, 2, 3] + [4] * (n - 1), device=dev)
    csr = CSR(indptr, torch.tensor([0, n, n + 1, 1], dtype=torch.int32, device=dev), None, (n, n + 2))
    for run in (lambda: feature.JaccardWeights().get_jaccard_weights(csr),
                lambda: feature.TriangleCount().get_triangle_count(csr),
                lambda: feature.TriangleCount(True).get_triangle_count(csr)):
        with pytest.raises(ValueError, match="more columns than rows"):
            run()


def reorder_graph(gen, dev, n, nnz, shape=None):
    """A COO of ``nnz`` entries, rows uniform and a fifth of the columns from
    a clump (path A's generator), duplicates kept, row-major sorted."""
    n_rows, n_cols = shape or (n, n)
    row = torch.randint(0, n_rows, (nnz,), generator=gen, device=dev, dtype=torch.int32)
    col = torch.randint(0, n_cols, (nnz,), generator=gen, device=dev, dtype=torch.int32)
    clump = torch.randint(0, max(n_cols // 100, 1), (nnz,), generator=gen, device=dev, dtype=torch.int32)
    col = torch.where(torch.rand((nnz,), generator=gen, device=dev) < 0.2, clump, col)
    return COO.new(row, col, None, (n_rows, n_cols))


@pytest.mark.parametrize("shape", [(200_000, 200_000), (50_000, 80_000), (80_000, 50_000), (1_000, 20)],
                         ids=["square", "wide", "tall", "narrow"])
def test_gray_boba_heatmap_on_card_equal_the_cpu(dev, gen, shape):
    """Gray, BOBA and the heatmap run on the card (each stays there: no
    result moves to the CPU) and equal their CPU routes exactly (``mean_bw``
    too: both sum exactly)."""
    from sparsebase_tpu_torch import ReorderBase
    from sparsebase_tpu_torch.ops.reorder import BOBAReorder, GrayReorder

    coo = reorder_graph(gen, dev, None, 1_000_000 if shape[0] > 1_000 else 20_000, shape)
    csr = coo.convert(CSR)
    host_coo, host_csr = coo.to_host(), csr.to_host()
    for kw in (dict(), dict(resolution=16, nnz_threshold=4), dict(resolution=64, sparse_density_group_size=1)):
        got = GrayReorder(**kw).get_reorder(csr)
        assert got.device.type == "cuda" and got.dtype == torch.int32
        assert torch.equal(got.cpu(), GrayReorder(**kw).get_reorder(host_csr)), kw
    got = BOBAReorder().get_reorder(coo)
    assert got.device.type == "cuda" and torch.equal(got.cpu(), BOBAReorder().get_reorder(host_coo))
    n, m = shape
    orders = (torch.arange(n, device=dev), torch.arange(m, device=dev))
    if n == m:
        orders = (got, got)
    for parts in (1, 8, 20):
        heat, stats = ReorderBase.heatmap_with_stats(csr, *orders, num_parts=parts)
        want_heat, want = ReorderBase.heatmap_with_stats(host_csr, *(o.cpu() for o in orders), num_parts=parts)
        assert heat.vals.device.type == "cuda" and torch.equal(heat.vals.cpu(), want_heat.vals)
        assert stats == want


def test_gray_and_boba_make_no_host_sync(dev, gen):
    from sparsebase_tpu_torch.ops.reorder import BOBAReorder, GrayReorder

    coo = reorder_graph(gen, dev, 100_000, 1_000_000)
    csr = coo.convert(CSR)
    for op, fmt in ((GrayReorder(), csr), (BOBAReorder(), coo)):
        op.get_reorder(fmt)  # builds and loads the kernels
        syncs, got = count_syncs(lambda: op.get_reorder(fmt))
        assert not syncs, (type(op).__name__, [str(w.message) for w in syncs])


@pytest.mark.parametrize("name", ["slashburn", "amd", "metis", "rabbit"])
def test_host_reorderers_return_to_the_card(dev, gen, name):
    """A host reorderer copies a CUDA CSR to the host once and returns an
    int32 order on the card, equal to the call on a CPU copy."""
    from sparsebase_tpu_torch import ReorderBase

    coo = reorder_graph(gen, dev, 3_000, 20_000)
    csr = COO.new(torch.cat([coo.row, coo.col]), torch.cat([coo.col, coo.row]), None, coo.shape).convert(CSR)
    params = {"k_size": 8} if name == "slashburn" else None
    got = ReorderBase.reorder(name, csr, params=params)
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got.cpu(), ReorderBase.reorder(name, csr.to_host(), params=params))


# -- K7: a label-propagation round ----------------------------------------------------
def lp_case(gen, dev, n, avg_deg, k, *, long_rows=(), tail=None, empty_every=0, misaligned=False, weights=None,
            skew=True, exact=False, one_part=False, outside=False):
    """A CSR of ``n`` rows (Poisson-like degrees around ``avg_deg``, or
    exactly ``avg_deg`` with ``exact``; ids uniform in [0, n)), with the
    ``(row, length)`` pairs of ``long_rows`` and, with ``tail = (count,
    top)``, ``count`` rows spread evenly over the rows whose lengths fall as
    ``top / i^0.8`` (a power-law tail); labels in [0, k) with half the
    vertices in part 0 when ``skew`` (so that the penalty bites), or all in
    part k - 1 with ``one_part``, some outside [0, k) with ``outside``
    (they count nowhere), and weights: None, "integer" (1..5) or "real"."""
    deg = torch.randint(0, 2 * avg_deg + 1, (n,), generator=gen, device=dev)
    if exact:
        deg.fill_(avg_deg)
    if empty_every:
        deg[::empty_every] = 0
    if tail is not None:
        count, top = tail
        rows = torch.linspace(0, n - 1, count, device=dev).long()
        deg[rows] = (top / torch.arange(1, count + 1, device=dev, dtype=torch.float64) ** 0.8).long()
    for row, length in long_rows:
        deg[row] = length
    indptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), deg.cumsum(0)])
    nnz = int(indptr[-1])
    ids = torch.randint(0, n, (nnz,), generator=gen, device=dev, dtype=torch.int32)
    if misaligned:
        ids = off_alignment(ids)
    w = None
    if weights == "integer":
        w = torch.randint(1, 6, (nnz,), generator=gen, device=dev).to(torch.float32)
    elif weights == "real":
        w = torch.rand((nnz,), generator=gen, device=dev) * 3
    labels = torch.randint(0, k, (n,), generator=gen, device=dev, dtype=torch.int32)
    if skew:
        labels[: n // 2] = 0
    if one_part:
        labels.fill_(k - 1)
    if outside:
        labels[::5] = k + 300
        labels[1::7] = -3
    return CSR(indptr, ids, w, (n, n)), labels


# name -> (n, average degree, k, options). K7 keeps each row's k cells
# between its launches where n * k <= nnz ("stored"), counts in registers up
# to k = 8 and in shared memory up to k = 6,140, and gathers from a 1-byte
# copy of the labels up to k = 255. Unweighted on the stored register tier,
# rows over SPLIT_ROWS entries go to the span pass.
T = SPLIT_ROWS
LP_CASES = {
    "k2": (200_000, 16, 2, {}),
    "k8": (500_000, 16, 8, {}),
    "k8-balanced": (500_000, 16, 8, dict(skew=False)),
    "k64": (100_000, 12, 64, {}),
    "k65": (50_000, 12, 65, {}),
    "k4096": (20_000, 40, 4_096, {}),
    "k6140-last-shared": (4_000, 30, 6_140, {}),
    "k6141-first-global": (4_000, 30, 6_141, {}),
    "k8192-global-tier": (5_000, 30, 8_192, {}),
    "long-row": (50_000, 16, 8, dict(long_rows=((7, 262_144),))),
    "long-row-k128": (20_000, 16, 128, dict(long_rows=((19_999, 262_144),))),
    "empty-rows": (100_000, 16, 8, dict(empty_every=3)),
    "no-entries": (1_000, 0, 8, {}),
    "one-row": (1, 5, 8, {}),
    "ids-off-alignment": (100_000, 16, 8, dict(misaligned=True)),
    "integer-weights": (200_000, 16, 8, dict(weights="integer")),
    "integer-weights-k4096": (10_000, 40, 4_096, dict(weights="integer")),
    "integer-weights-global-tier": (3_000, 30, 8_192, dict(weights="integer")),
    "real-weights": (200_000, 16, 8, dict(weights="real")),
    "real-weights-k200": (50_000, 16, 200, dict(weights="real")),
    "stored-n-k-equal-nnz": (100_000, 8, 8, dict(exact=True)),
    "two-pass-n-k-one-over-nnz": (100_000, 8, 9, dict(exact=True)),
    "k8-last-register-two-pass": (100_000, 7, 8, dict(exact=True)),
    "k9-first-shared-stored": (100_000, 9, 9, dict(exact=True)),
    "k16-shared-stored": (100_000, 16, 16, dict(exact=True)),
    "one-part-k8": (300_000, 16, 8, dict(one_part=True)),
    "one-part-k16": (100_000, 16, 16, dict(one_part=True)),
    "one-part-k64": (50_000, 64, 64, dict(one_part=True)),
    "integer-weights-stored-k16": (100_000, 16, 16, dict(weights="integer", exact=True)),
    "real-weights-stored-k12": (100_000, 16, 12, dict(weights="real")),
    "real-weights-stored-k200": (2_000, 250, 200, dict(weights="real")),
    "k255-last-byte-gather-stored": (20_000, 300, 255, dict(exact=True)),
    "k256-first-int-gather-stored": (20_000, 300, 256, dict(exact=True)),
    "labels-outside-k8": (100_000, 16, 8, dict(outside=True)),
    "labels-outside-k255": (20_000, 16, 255, dict(outside=True)),
    "split-power-law-tail": (200_000, 16, 8, dict(tail=(400, 300 * T))),
    "split-power-law-tail-k3": (200_000, 16, 3, dict(tail=(400, 300 * T))),
    "split-rows-of-t-and-t-plus-1": (100_000, 16, 8, dict(long_rows=((5, T), (6, T + 1), (50_000, T + 1),
                                                                      (50_001, T), (99_998, T - 1)))),
    "split-star-row": (100_000, 4, 8, dict(long_rows=((40_000, 4_000_000),))),
    "split-long-row-one-part": (100_000, 16, 8, dict(long_rows=((3, 50 * T),), one_part=True)),
    "split-long-row-labels-outside": (100_000, 16, 8, dict(long_rows=((3, 50 * T),), outside=True)),
    "split-long-rows-first-and-last": (100_000, 16, 8, dict(long_rows=((0, 30 * T + 7), (99_999, 20 * T + 3)))),
    "split-two-pass-long-row": (100_000, 2, 8, dict(long_rows=((77, 100 * T),))),
    "split-long-row-integer-weights": (100_000, 16, 8, dict(long_rows=((3, 50 * T),), weights="integer")),
    "split-long-row-real-weights": (100_000, 16, 8, dict(long_rows=((3, 50 * T),), weights="real")),
}


def lp_scores(csr, labels, k, alpha, cap):
    from sparsebase_tpu_torch.ops.kernels.label_prop import neighbor_counts, part_counts, penalty_plain

    counts = neighbor_counts(csr, labels, k, csr.vals)
    return counts - penalty_plain(counts, part_counts(labels, k), alpha, cap)[None, :]


@pytest.mark.parametrize("alpha", [0.1, 1.0])
@pytest.mark.parametrize("case", sorted(LP_CASES))
def test_label_prop_kernel_matches_plain(dev, gen, case, alpha):
    """K7 equals its plain version bit for bit where the counts are integers;
    with real weights, a row may differ only where its two best scores lie
    within 8 ulp (the card's plain version sums in another order)."""
    from sparsebase_tpu_torch.ops.kernels import label_prop_round, label_prop_round_plain

    n, avg_deg, k, opts = LP_CASES[case]
    csr, labels = lp_case(gen, dev, n, avg_deg, k, **opts)
    cap = 1.1 * n / k
    before = _build.launch_counts()["label_prop"]
    got = label_prop_round(csr, labels, k, alpha, cap, csr.vals)
    assert _build.launch_counts()["label_prop"] == before + 1
    want = label_prop_round_plain(csr, labels, k, alpha, cap, csr.vals)
    assert got.dtype == torch.int32 and got.device == labels.device and got.shape == (n,)
    assert torch.equal(label_prop_round(csr, labels, k, alpha, cap, csr.vals), got)  # two runs agree
    if opts.get("weights") != "real":
        assert torch.equal(got, want)
        return
    diff = torch.nonzero(got != want).flatten()
    if diff.numel():
        scores = lp_scores(csr, labels, k, alpha, cap)[diff]
        a = scores.gather(1, got[diff].long()[:, None]).flatten()
        b = scores.gather(1, want[diff].long()[:, None]).flatten()
        ulp = torch.finfo(torch.float32).eps * torch.maximum(a.abs(), b.abs())
        assert bool(((a - b).abs() <= 8 * ulp).all()), (diff.numel(), (a - b).abs().max())


@pytest.mark.parametrize("tail", [None, (300, 200 * SPLIT_ROWS)], ids=["no-long-rows", "split"])
def test_label_prop_makes_no_host_sync(dev, gen, tail):
    """Ten rounds of ``_propagate`` on the card, run to the end, read nothing
    back; they equal the same rounds through the plain version. Each round
    counts ``label_prop.split_rounds`` once (its plan hands the rows over
    SPLIT_ROWS to the span pass, on this graph or not); ``split_rows``
    reports the rows and entries that take it."""
    from sparsebase_tpu_torch.ops.kernels import label_prop_round_plain
    from sparsebase_tpu_torch.ops.partition.labelprop import _propagate
    from sparsebase_tpu_torch.utils import tracing

    csr, labels = lp_case(gen, dev, 300_000, 16, 8, skew=False, tail=tail)
    cap = 1.1 * csr.nrows / 8
    _propagate(csr, labels, 8, cap, None, 1, stop_when_stable=False)  # builds and loads the kernels
    before = tracing.counters().get("label_prop.split_rounds", 0)
    syncs, got = count_syncs(lambda: _propagate(csr, labels, 8, cap, None, 10, stop_when_stable=False))
    assert not syncs, [str(w.message) for w in syncs]
    assert tracing.counters().get("label_prop.split_rounds", 0) == before + 10
    want = labels
    for it in range(10):
        want = label_prop_round_plain(csr, want, 8, (it + 1) / 10, cap)
    assert torch.equal(got, want)
    rows, entries = split_rows(csr)
    deg = (csr.indptr[1:] - csr.indptr[:-1]).cpu()
    assert (rows, entries) == (int((deg > SPLIT_ROWS).sum()), int(deg[deg > SPLIT_ROWS].sum()))
    assert (rows > 0) == (tail is not None) and entries / csr.nnz < (0.5 if tail else 1e-9)


@pytest.mark.parametrize("case", ["stored-n-k-equal-nnz", "two-pass-n-k-one-over-nnz", "k8-last-register-two-pass",
                                  "k9-first-shared-stored", "k8192-global-tier"])
def test_label_prop_scratch_holds_the_cells_where_n_k_fits_in_nnz(dev, gen, case):
    """The scratch holds the n * k stored cells exactly where n * k <= nnz
    and k <= 6,140 (at most 4 * nnz bytes more) and, on the register tier
    (k <= 8), room after them for the rows the span pass may take (24 bytes
    each, at most nnz / (SPLIT_ROWS + 1) rows); without them it is the same
    for any nnz (O(k) bytes and, k <= 255, the n 1-byte labels; or the
    global tier's histograms)."""
    from sparsebase_tpu_torch.ops.kernels.label_prop import _scratch_bytes

    n, avg_deg, k, opts = LP_CASES[case]
    csr, _ = lp_case(gen, dev, n, avg_deg, k, **opts)
    small = _scratch_bytes()(n, k, 0)  # no entries: never stored
    got = _scratch_bytes()(n, k, csr.nnz)
    if n * k <= csr.nnz and k <= 8:
        cells = -(-4 * n * k // 256) * 256
        assert got == small + cells + 24 * (csr.nnz // (SPLIT_ROWS + 1))
    elif n * k <= csr.nnz and k <= 6_140:
        assert got == small + 4 * n * k and got - small <= 4 * csr.nnz
    else:
        assert got == small


def test_label_prop_rounds_on_each_route_make_no_host_sync(dev, gen):
    """Ten rounds of ``_propagate`` read nothing back on the stored route
    (k = 8, 16 entries a row), the two-pass route (k = 8, 4 entries a row)
    and the shared-memory tier (k = 100); each equals the plain rounds."""
    from sparsebase_tpu_torch.ops.kernels import label_prop_round_plain
    from sparsebase_tpu_torch.ops.partition.labelprop import _propagate

    for avg_deg, k in ((16, 8), (4, 8), (16, 100)):
        csr, labels = lp_case(gen, dev, 100_000, avg_deg, k, skew=False)
        cap = 1.1 * csr.nrows / k
        _propagate(csr, labels, k, cap, None, 1, stop_when_stable=False)
        syncs, got = count_syncs(lambda: _propagate(csr, labels, k, cap, None, 10, stop_when_stable=False))
        assert not syncs, (avg_deg, k, [str(w.message) for w in syncs])
        want = labels
        for it in range(10):
            want = label_prop_round_plain(csr, want, k, (it + 1) / 10, cap)
        assert torch.equal(got, want), (avg_deg, k)


def test_label_prop_of_no_rows(dev):
    from sparsebase_tpu_torch.ops.kernels import label_prop_round

    empty = CSR(torch.zeros(1, dtype=torch.int64, device=dev), torch.zeros(0, dtype=torch.int32, device=dev), None,
                (0, 0))
    got = label_prop_round(empty, torch.zeros(0, dtype=torch.int32, device=dev), 8, 1.0, 1.0)
    assert got.shape == (0,) and got.dtype == torch.int32 and got.device == dev


def test_kernels_return_a_failed_device_query(tmp_path):
    """K3, K4, K6 and K7 read the SM count at each launch and return the
    query's error: in a process that sees no card, each C entry point
    returns the same CUDA error (cudaErrorNoDevice) and launches nothing."""
    import subprocess
    import sys

    lib = _build.build()
    script = tmp_path / "no_card.py"
    script.write_text(f"""
import ctypes
lib = ctypes.CDLL({str(lib)!r})
V, I = ctypes.c_void_p, ctypes.c_int64
calls = {{
    "sb_indptr_from_sorted_rows": ([V, I, I, V, V], (None, 16, 4, None, None)),
    "sb_relocate_csr": ([V] * 6 + [I, ctypes.c_int, V, I] + [V] * 5, (None,) * 6 + (4, 1, None, 4) + (None,) * 5),
    "sb_common_neighbors": ([V, V, I, I, ctypes.c_int, V, V, V, I, V, V, V], (None, None, 4, 16, 0) + (None,) * 3
                            + (16,) + (None,) * 3),
    "sb_label_prop_round": ([V] * 4 + [I] * 3 + [ctypes.c_float] * 3 + [V] * 3, (None,) * 4 + (4, 16, 8, 0.5, 1.0, 1.0)
                            + (None,) * 3),
}}
for name, (types, args) in calls.items():
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = types, ctypes.c_int
    print(name, fn(*args))
""")
    env = dict(__import__("os").environ, CUDA_VISIBLE_DEVICES="")
    run = subprocess.run([sys.executable, str(script)], capture_output=True, text=True, env=env, timeout=120)
    assert run.returncode == 0, run.stderr
    codes = dict(line.split() for line in run.stdout.split("\n") if line)
    assert set(codes) == {"sb_indptr_from_sorted_rows", "sb_relocate_csr", "sb_common_neighbors",
                          "sb_label_prop_round"}
    assert len(set(codes.values())) == 1 and codes["sb_indptr_from_sorted_rows"] != "0", codes


def test_label_prop_raises_without_its_library(dev, gen, tmp_path, monkeypatch):
    """A CUDA CSR never takes the plain version: with no compiler and no
    built library the round raises."""
    import importlib

    from sparsebase_tpu_torch.ops.kernels import label_prop_round

    lp = importlib.import_module("sparsebase_tpu_torch.ops.kernels.label_prop")
    csr, labels = lp_case(gen, dev, 1_000, 8, 4)
    monkeypatch.setattr(_build, "_LIBRARY", None)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(tmp_path / "no-such-nvcc"))
    monkeypatch.setattr(lp._K7, "_fn", None)
    lp._scratch_bytes.cache_clear()
    try:
        with pytest.raises((FileNotFoundError, _build.KernelBuildError)):
            label_prop_round(csr, labels, 4, 0.5, 1.1 * 1_000 / 4)
    finally:
        lp._scratch_bytes.cache_clear()


def partition_graph(gen, dev, n, pairs):
    """A symmetric COO of ``2 * pairs`` uniform entries, row-major sorted."""
    row = torch.randint(0, n, (pairs,), generator=gen, device=dev, dtype=torch.int32)
    col = torch.randint(0, n, (pairs,), generator=gen, device=dev, dtype=torch.int32)
    return COO.new(torch.cat([row, col]), torch.cat([col, row]), None, (n, n))


def test_partition_pipeline_on_card_equals_cpu(dev, gen):
    """``partition_pipeline`` launches K3, K7 (one a round), K5, K4 and K2,
    and its labels and permuted CSR equal the CPU call's; ``y`` agrees per
    row within the reordered-sum bound."""
    from sparsebase_tpu_torch.models import partition_pipeline

    coo = partition_graph(gen, dev, 200_000, 1_600_000)
    coo = COO(coo.row, coo.col, torch.randn((coo.nnz,), generator=gen, device=dev), coo.shape)
    x = torch.randn((coo.nrows,), generator=gen, device=dev)
    _build.reset_launch_counts()
    permuted, y, labels = partition_pipeline(coo, x, 8, 10)
    counts = _build.launch_counts()
    assert counts["label_prop"] == 10
    assert all(counts[name] >= 1 for name in ("indptr", "radix_rank", "relocate_csr", "csr_spmv"))
    host = coo.to_host()
    want_p, want_y, want_l = partition_pipeline(host, x.cpu(), 8, 10)
    assert labels.device == x.device and torch.equal(labels.cpu(), want_l)
    assert torch.equal(permuted.indptr.cpu(), want_p.indptr) and torch.equal(permuted.indices.cpu(), want_p.indices)
    assert torch.equal(permuted.vals.cpu(), want_p.vals)
    abs_p = CSR(permuted.indptr, permuted.indices, permuted.vals.abs(), permuted.shape)
    x_new = torch.empty_like(x)
    x_new[radix_rank_plain(labels.long())] = x  # ro[old] = new: grouped by label, in id order within a part
    assert_rows_within(y, csr_spmv_plain(permuted, x_new), permuted.degrees(), csr_spmv_plain(abs_p, x_new.abs()))


@pytest.mark.parametrize("name", ["pulp", "pulp-no-graphkit", "metis", "metis-rb", "patoh"])
def test_partitioners_on_card_equal_the_cpu(dev, gen, name):
    """Each partitioner returns int32 labels on the card equal to the same
    call on a CPU copy; Pulp without graphkit runs K7."""
    from sparsebase_tpu_torch import get_config, set_config
    from sparsebase_tpu_torch.ops.partition import MetisPartition, PatohPartition, PulpPartition

    csr = partition_graph(gen, dev, 3_000, 12_000).convert(CSR)
    op = {"pulp": PulpPartition(num_partitions=8), "pulp-no-graphkit": PulpPartition(num_partitions=8),
          "metis": MetisPartition(num_partitions=8), "metis-rb": MetisPartition(num_partitions=8, ptype="rb"),
          "patoh": PatohPartition(num_partitions=8)}[name]
    saved = get_config().use_graphkit
    set_config(use_graphkit=name != "pulp-no-graphkit")
    try:
        before = _build.launch_counts()["label_prop"]
        got = op.partition(csr)
        launched = _build.launch_counts()["label_prop"] - before
        want = op.partition(csr.to_host())
    finally:
        set_config(use_graphkit=saved)
    assert got.device == csr.indptr.device and got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)
    assert (launched > 0) == (name == "pulp-no-graphkit")


# -- the harness: experiment, visualizer, bench_suite ----------------------------

HARNESS_MTX = """%%MatrixMarket matrix coordinate real symmetric
6 6 7
1 1 2.5
2 1 -1.0
3 2 4.0
4 3 0.5
5 1 3.0
6 4 -2.0
6 5 1.5
"""


def test_harness_loaders_place_on_the_card(tmp_path, dev):
    from sparsebase_tpu_torch import experiment

    p = tmp_path / "m.mtx"
    p.write_text(HARNESS_MTX)
    for load in (experiment.load_csr, experiment.load_coo, experiment.load_csc, experiment.load_format(COO)):
        out = load([str(p)])
        assert all(t.device.type == "cuda" for t in out._tensors())
        assert out.nnz == 13


def _sleep_experiment(cycles, returns):
    from sparsebase_tpu_torch.experiment import ConcreteExperiment, pass_preprocess

    def kernel(data, fparams, pparams, kparams):
        torch.cuda._sleep(cycles)
        return {"out": [torch.ones((2,), device="cuda")]} if returns else None

    e = ConcreteExperiment(warmup=1)
    e.add_data_loader(lambda files: files, [(["none"], None)])
    e.add_preprocess("pass", pass_preprocess)
    e.add_kernel("sleep", kernel)
    return e


@pytest.mark.parametrize("returns", [True, False], ids=["returns-a-tensor", "returns-none"])
def test_experiment_waits_for_enqueued_work(dev, returns):
    """A kernel that enqueues about 50 ms of work is recorded at 50 ms or
    more, whether it returns a CUDA tensor (in a dict of lists) or nothing."""
    torch.cuda._sleep(1_000_000)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    torch.cuda.synchronize()
    cycles = int(10_000_000 * 50.0 / start.elapsed_time(end) * 1.05)
    times = _sleep_experiment(cycles, returns).run(times=3).get_run_times()
    assert len(times) == 3 and all(t >= 0.050 for t in times.values()), times


def test_experiment_trace_holds_the_device_kernels(tmp_path, dev, gen):
    """A traced run of ``spmv`` (K2) on the card: its Chrome trace holds the
    run's scope, the dispatch span and K2's kernels as device events."""
    import json

    from sparsebase_tpu_torch.experiment import ConcreteExperiment, pass_preprocess

    csr = device_csr(gen, dev, torch.full((50_000,), 8), 50_000)
    e = ConcreteExperiment(warmup=0, trace_dir=str(tmp_path))
    e.add_data_loader(lambda files: csr, [(["csr"], None)])
    e.add_preprocess("pass", pass_preprocess)
    e.add_kernel("spmv", lambda data, *params: spmv(data, torch.ones((data.ncols,), device=dev)))
    e.run()
    events = json.loads((tmp_path / "pass-spmv-0" / "trace.json").read_text())["traceEvents"]
    names = {ev.get("name") for ev in events}
    kernels = " ".join(str(ev.get("name")) for ev in events if ev.get("cat") == "kernel")
    assert "pass-spmv-0" in names and "sbtorch:op:spmv" in names
    assert "csr_spmv_tiles" in kernels and "csr_spmv_fixup" in kernels, kernels


def test_experiment_raises_when_a_kernel_raises_on_the_card(dev):
    from sparsebase_tpu_torch.experiment import ConcreteExperiment, pass_preprocess

    def kernel(data, fparams, pparams, kparams):
        torch.ones((4,), device=dev).sum()
        raise RuntimeError("a failing kernel")

    e = ConcreteExperiment(warmup=0)
    e.add_data_loader(lambda files: files, [(["none"], None)])
    e.add_preprocess("pass", pass_preprocess)
    e.add_kernel("fails", kernel)
    with pytest.raises(RuntimeError, match="a failing kernel"):
        e.run()


@pytest.mark.parametrize("weights", [False, True], ids=["counts", "weights"])
def test_visualizer_grids_on_card_equal_the_cpu(dev, gen, weights):
    """The dashboard of a CUDA CSR: each grid equal to the CPU's (counts
    exactly, ``|values|`` at rtol 1e-12), the stats equal, and the HTML of
    the count grids equal to the CPU's."""
    from sparsebase_tpu_torch.utils.visualizer import _report

    csr = partition_graph(gen, dev, 50_000, 400_000).convert(CSR)
    csr = CSR(csr.indptr, csr.indices, torch.randn((csr.nnz,), generator=gen, device=dev), csr.shape)
    card = _report(csr, "card", ("degree", "gray", "boba"), 64, plot_edges_by_weights=weights)
    host = _report(csr.to_host(), "card", ("degree", "gray", "boba"), 64, plot_edges_by_weights=weights)
    for (ro, _, _), (ro_h, _, _) in zip(card._orderings.values(), host._orderings.values()):
        assert ro.device.type == "cuda" and torch.equal(ro.cpu(), ro_h)
        grid, stats = card._density(ro, ro)
        want, want_stats = host._density(ro_h, ro_h)
        assert stats == want_stats
        if weights:
            np.testing.assert_allclose(grid, want, rtol=1e-12, atol=0)
        else:
            np.testing.assert_array_equal(grid, want)
    if not weights:
        assert card.to_html() == host.to_html()


def test_bench_suite_run_matrix_on_card_equals_cpu(dev):
    """``run_matrix`` on a small synthetic graph on the card: every field
    that is not a time equal to the same call on a CPU copy."""
    from sparsebase_tpu_torch import bench_suite

    g = bench_suite.synthetic_graph(3_000, 8)
    assert g.indptr.device.type == "cuda"

    def without_times(e):
        if isinstance(e, dict):
            return {k: without_times(v) for k, v in e.items() if k not in ("seconds", "convert_roundtrip_nnz_per_s")}
        return e

    card = bench_suite.run_matrix("rand-3k", g)
    host = bench_suite.run_matrix("rand-3k", g.to_host())
    assert without_times(card) == without_times(host)
    assert card["rand-3k"]["hypergraph_k4"]["connectivity_minus_1"] > 0


# -- the distributed tier: four shards on the card against four on the CPU --------
def parallel_graph(gen, dev, n=20_000, nnz=200_000):
    """Random entries with duplicates kept, values, in random order (the
    ingest routes entries in any order)."""
    row = torch.randint(0, n, (nnz,), generator=gen, device=dev, dtype=torch.int32)
    col = torch.randint(0, n, (nnz,), generator=gen, device=dev, dtype=torch.int32)
    return COO(row, col, torch.randn((nnz,), generator=gen, device=dev), (n, n))


def parallel_csr(gen, dev, n=20_000):
    coo = parallel_graph(gen, dev, n)
    return COO.new(coo.row, coo.col, coo.vals, coo.shape).convert(CSR)


def within_bound_of_plain(y, csr, x):
    absolute = CSR(csr.indptr, csr.indices, csr.vals.abs(), csr.shape)
    assert_rows_within(y, csr_spmv_plain(csr, x), csr.degrees(), csr_spmv_plain(absolute, x.abs()))


@pytest.fixture
def shard_meshes(dev):
    from sparsebase_tpu_torch.parallel import make_mesh

    return make_mesh(devices=[dev] * 4), make_mesh(devices=["cpu"] * 4)


def test_parallel_ingest_and_halo_on_card_equal_cpu(dev, gen, shard_meshes):
    """``from_coo_sharded`` (K5 sorts, K3 indptr) and ``with_halo`` (K5) on
    a 4-shard mesh of the card: every field equal to the CPU mesh's (both
    sorts are stable, so duplicates keep one order), the same widths."""
    from sparsebase_tpu_torch.parallel import ShardedCSR

    card_mesh, cpu_mesh = shard_meshes
    coo = parallel_graph(gen, dev)
    host = coo.to_host()
    before = _build.launch_counts()
    stats, host_stats = {}, {}
    card = ShardedCSR.from_coo_sharded(coo.row, coo.col, coo.vals, coo.shape, card_mesh, stats=stats).with_halo()
    want = ShardedCSR.from_coo_sharded(host.row, host.col, host.vals, host.shape, cpu_mesh, stats=host_stats).with_halo()
    after = _build.launch_counts()
    assert after["radix_rank"] >= before["radix_rank"] + 12 and after["indptr"] >= before["indptr"] + 4
    assert stats == host_stats and card.devices == (dev,) * 4
    for name in ("indptr", "indices", "vals", "nnz_local", "halo_send", "halo_counts", "halo_map"):
        assert torch.equal(card.stacked(name).cpu(), want.stacked(name)), name


def test_parallel_spmv_and_label_prop_on_card(dev, gen, shard_meshes):
    """``dist.spmv`` (K2 per shard) within the per-row bound of the plain
    SpMV of the whole CSR, and ``label_prop_partition`` equal to the CPU
    mesh's labels."""
    from sparsebase_tpu_torch.parallel import ShardedCSR, dist

    card_mesh, cpu_mesh = shard_meshes
    csr = parallel_csr(gen, dev)
    x = torch.randn((csr.ncols,), generator=gen, device=dev)
    sh = ShardedCSR.from_csr(csr, card_mesh, halo=False)
    before = _build.launch_counts()["csr_spmv"]
    y = dist.spmv(sh, x, card_mesh)
    assert _build.launch_counts()["csr_spmv"] == before + 4 and y.device == dev
    within_bound_of_plain(y, csr, x)
    labels = dist.label_prop_partition(sh, 8, card_mesh, num_iters=10)
    host = ShardedCSR.from_csr(csr.to_host(), cpu_mesh, halo=False)
    assert labels.device == dev and torch.equal(labels.cpu(), dist.label_prop_partition(host, 8, cpu_mesh, num_iters=10))


HALO_FUNCTIONS = {  # name -> call on (sharded, mesh, stats); labels on the mesh's first device
    "bfs_levels": lambda sh, m, st: halo.bfs_levels(sh, 0, m, stats=st),
    "rcm_reorder": lambda sh, m, st: halo.rcm_reorder(sh, m, stats=st),
    "label_prop_partition": lambda sh, m, st: halo.label_prop_partition(sh, 8, m, num_iters=6),
    "connected_components": lambda sh, m, st: halo.connected_components(sh, m, stats=st),
    "edge_cut": lambda sh, m, st: halo.edge_cut(sh, chunk_labels(sh.shape[0], m.first_device), m),
    "refine_partition": lambda sh, m, st: halo.refine_partition(sh, chunk_labels(sh.shape[0], m.first_device), 8, m,
                                                                rounds=3),
}


def chunk_labels(n, dev):
    return (torch.arange(n, device=dev) * 8 // n).to(torch.int32)


@pytest.mark.parametrize("shape", [(20_000, 20_000), (20_000, 35_000)], ids=["square", "more-columns"])
def test_halo_on_card_equals_cpu(dev, gen, shard_meshes, shape):
    """Every ``halo`` function on a 4-shard mesh of the card equal to the
    CPU mesh's result, on a square matrix and on one with more columns than
    rows (no out-of-range index reaches the card, for ``dist`` either);
    ``halo.spmv`` (K2 per shard) within the per-row bound of the plain SpMV.
    The counting rank and the refinement launch K5 and K3; a function syncs
    the host only for the reads its loops count."""
    from sparsebase_tpu_torch.parallel import ShardedCSR, dist

    card_mesh, cpu_mesh = shard_meshes
    n, m = shape
    row = torch.randint(0, n, (200_000,), generator=gen, device=dev, dtype=torch.int32)
    col = torch.randint(0, m, (200_000,), generator=gen, device=dev, dtype=torch.int32)
    csr = COO.new(row, col, torch.randn((200_000,), generator=gen, device=dev), shape).convert(CSR)
    sh = ShardedCSR.from_csr(csr, card_mesh)
    host = ShardedCSR.from_csr(csr.to_host(), cpu_mesh)
    x = torch.randn((n,), generator=gen, device=dev)
    y = halo.spmv(sh, x, card_mesh)
    assert y.device == dev and torch.allclose(y.cpu(), halo.spmv(host, x.cpu(), cpu_mesh), rtol=1e-5, atol=1e-5)
    if n == m:
        within_bound_of_plain(y, csr, x)
    assert torch.equal(dist.bfs_levels(sh, 0, card_mesh).cpu(), dist.bfs_levels(host, 0, cpu_mesh))
    assert torch.equal(dist.rcm_reorder(sh, card_mesh).cpu(), dist.rcm_reorder(host, cpu_mesh))
    assert torch.equal(dist.label_prop_partition(sh, 2, card_mesh).cpu(), dist.label_prop_partition(host, 2, cpu_mesh))
    before = _build.launch_counts()
    for name, fn in HALO_FUNCTIONS.items():
        stats = {}
        syncs, got = count_syncs(lambda: fn(sh, card_mesh, stats))
        assert got.device == dev and torch.equal(got.cpu(), fn(host, cpu_mesh, {})), name
        assert len(syncs) == stats.get("host_reads", 0), (name, len(syncs), stats)
    after = _build.launch_counts()
    assert after["radix_rank"] > before["radix_rank"] and after["indptr"] > before["indptr"]


def test_sharded2d_on_card(dev, gen):
    """``Sharded2DCSR.from_csr`` on a 2×2 mesh of the card equal to the CPU
    mesh's tiles; its ``spmv`` (K2 per tile) within the per-row bound."""
    from sparsebase_tpu_torch.parallel import Sharded2DCSR, make_mesh_2d, sharded2d

    csr = parallel_csr(gen, dev, 30_001)
    card_mesh, cpu_mesh = make_mesh_2d((2, 2), devices=[dev] * 4), make_mesh_2d((2, 2), devices=["cpu"] * 4)
    tiles = Sharded2DCSR.from_csr(csr, card_mesh)
    want = Sharded2DCSR.from_csr(csr.to_host(), cpu_mesh)
    for name in ("indptr", "indices", "vals", "nnz_local"):
        assert torch.equal(tiles.stacked(name).cpu(), want.stacked(name)), name
    x = torch.randn((csr.ncols,), generator=gen, device=dev)
    y = sharded2d.spmv(tiles, x, card_mesh)
    within_bound_of_plain(y, csr, x)
    assert torch.equal(sharded2d.degrees(tiles, card_mesh), csr.degrees())


def symmetric_graph(gen, dev, n, pairs):
    """A symmetric random pattern on the card: ``pairs`` uniform pairs
    without self-loops, mirrored, repeats dropped."""
    u = torch.randint(0, n, (pairs,), generator=gen, device=dev)
    v = (u + torch.randint(1, n, (pairs,), generator=gen, device=dev)) % n
    keys = torch.unique(torch.cat([u * n + v, v * n + u]))
    return COO.new((keys // n).to(torch.int32), (keys % n).to(torch.int32), None, (n, n)).convert(CSR)


MULTILEVEL_FUNCTIONS = {  # name -> call on (sharded, mesh, stats), an int32 tensor on the mesh's first device
    "heavy_edge_matching": lambda sh, m, st: halo.heavy_edge_matching(sh, m),
    "heavy_edge_matching pattern": lambda sh, m, st: halo.heavy_edge_matching(sh, m, rounds=8, weighted=False),
    "coarsen": lambda sh, m, st: halo.coarsen(sh, halo.heavy_edge_matching(sh, m), m, return_mapping=True,
                                              stats=st)[1],
    "bfs_levels_multilevel": lambda sh, m, st: halo.bfs_levels_multilevel(sh, 0, m, coarsen_until=1000,
                                                                          stats=st)[0],
    "rcm_reorder_ml": lambda sh, m, st: halo.rcm_reorder_ml(sh, m, coarsen_until=1000, stats=st)[0],
    "multilevel_partition": lambda sh, m, st: halo.multilevel_partition(sh, 8, m, coarsen_until=1000, stats=st),
    "slashburn_reorder": lambda sh, m, st: halo.slashburn_reorder(sh, m, k_size=256, host_tail=0, host_tail_nnz=0,
                                                                  stats=st),
    "slashburn_reorder hybrid": lambda sh, m, st: halo.slashburn_reorder(sh, m, k_size=256, host_tail=2000,
                                                                         stats=st),
}


@pytest.mark.parametrize("name", sorted(MULTILEVEL_FUNCTIONS))
def test_multilevel_on_card_equals_cpu(dev, gen, shard_meshes, name):
    """Each multilevel ``halo`` function on a 4-shard mesh of the card equal
    to the CPU mesh's result on a symmetric random graph of 6,000 vertices;
    its host syncs (reads back and mask copies to the card) are the ones
    ``stats=`` counts. K5 and K3 launch in the contractions' route and the
    counting ranks; the hybrid SlashBurn, whose residual is host-sized after
    its first degree pass, ranks nothing on the card."""
    from sparsebase_tpu_torch.parallel import ShardedCSR

    card_mesh, cpu_mesh = shard_meshes
    csr = symmetric_graph(gen, dev, 6_000, 30_000)
    sh = ShardedCSR.from_csr(csr, card_mesh)
    host = ShardedCSR.from_csr(csr.to_host(), cpu_mesh)
    fn = MULTILEVEL_FUNCTIONS[name]
    before = _build.launch_counts()
    stats = {}
    syncs, got = count_syncs(lambda: fn(sh, card_mesh, stats))
    after = _build.launch_counts()
    assert got.device == dev and got.dtype == torch.int32
    assert torch.equal(got.cpu(), fn(host, cpu_mesh, {})), name
    assert len(syncs) == stats.get("host_reads", 0) + stats.get("host_writes", 0), (name, len(syncs), stats)
    # the matchings sort nothing; the hybrid SlashBurn hands this graph to
    # the host after one degree pass, before any counting rank
    if name not in ("heavy_edge_matching", "heavy_edge_matching pattern", "slashburn_reorder hybrid"):
        assert after["radix_rank"] > before["radix_rank"] and after["indptr"] > before["indptr"]
    else:
        assert stats.get("rounds", 0) <= 1


def test_coarse_graph_and_passes_on_card_equal_cpu(dev, gen, shard_meshes):
    """``coarsen``'s container, the level correction, the active-degree and
    neighbour-min passes, ``_coarsest_init`` and ``_enforce_balance`` on the
    card equal to the CPU mesh's."""
    from sparsebase_tpu_torch.parallel import ShardedCSR

    card_mesh, cpu_mesh = shard_meshes
    csr = symmetric_graph(gen, dev, 3_000, 12_000)
    sh, host = ShardedCSR.from_csr(csr, card_mesh), ShardedCSR.from_csr(csr.to_host(), cpu_mesh)
    match = halo.heavy_edge_matching(host, cpu_mesh)
    coarse, want = halo.coarsen(sh, match.to(dev), card_mesh), halo.coarsen(host, match, cpu_mesh)
    for name in ("indptr", "indices", "vals", "nnz_local", "halo_send", "halo_counts", "halo_map"):
        assert torch.equal(coarse.stacked(name).cpu(), want.stacked(name)), name
    lev = torch.randint(-1, 50, (3_000,), generator=gen, device=dev, dtype=torch.int32)
    assert torch.equal(halo._level_correct(sh, lev, card_mesh, 3).cpu(), halo._level_correct(host, lev.cpu(), cpu_mesh, 3))
    alive = torch.rand((3_000,), generator=gen, device=dev) < 0.7
    vals = torch.randint(0, 100, (3_000,), generator=gen, device=dev, dtype=torch.int32)
    for card_out, cpu_out in ((halo._active_degree(sh, halo._put(sh, alive, fill=False)),
                               halo._active_degree(host, halo._put(host, alive.cpu(), fill=False))),
                              (halo._nbr_min(sh, halo._put(sh, vals, fill=2**31 - 1)),
                               halo._nbr_min(host, halo._put(host, vals.cpu(), fill=2**31 - 1)))):
        assert all(torch.equal(a.cpu(), b) for a, b in zip(card_out, cpu_out))
    vw = torch.randint(1, 4, (3_000,), generator=gen, device=dev).to(torch.float32)
    assert torch.equal(halo._coarsest_init(sh, 4, card_mesh, vw, 1.1, 5).cpu(),
                       halo._coarsest_init(host, 4, cpu_mesh, vw.cpu(), 1.1, 5))
    over = torch.where(torch.arange(3_000, device=dev) < 2_000, 0, torch.arange(3_000, device=dev) % 4).to(torch.int32)
    got = halo._enforce_balance(sh, over, 4, card_mesh, 1.1)
    assert got.device == dev and torch.equal(got.cpu(), halo._enforce_balance(host, over.cpu(), 4, cpu_mesh, 1.1))


def test_ingest_drops_rows_past_n_on_card(dev, gen, shard_meshes):
    """Fault 3.5 on the card: entries whose row is n or more take route
    slots and are dropped; every field equal to the CPU mesh's."""
    from sparsebase_tpu_torch.parallel import ShardedCSR

    card_mesh, cpu_mesh = shard_meshes
    n = 20_000
    row = torch.randint(0, n, (200_000,), generator=gen, device=dev, dtype=torch.int32)
    col = torch.randint(0, n, (200_000,), generator=gen, device=dev, dtype=torch.int32)
    past = torch.rand((200_000,), generator=gen, device=dev) < 0.3
    row = torch.where(past, n + torch.randint(0, 3 * n, (200_000,), generator=gen, device=dev, dtype=torch.int32), row)
    vals = torch.randn((200_000,), generator=gen, device=dev)
    stats, host_stats = {}, {}
    card = ShardedCSR.from_coo_sharded(row, col, vals, (n, n), card_mesh, stats=stats).with_halo()
    want = ShardedCSR.from_coo_sharded(row.cpu(), col.cpu(), vals.cpu(), (n, n), cpu_mesh, stats=host_stats).with_halo()
    assert stats == host_stats and card.nnz == int((~past).sum())
    for name in ("indptr", "indices", "vals", "nnz_local", "halo_send", "halo_counts", "halo_map"):
        assert torch.equal(card.stacked(name).cpu(), want.stacked(name)), name


# -- the rings: four shards on the card against four on the CPU ---------------------
RING_FUNCTIONS = {  # name -> call on (sharded, mesh); a count or a tuple of per-shard tensors
    "triangle_count": ring.triangle_count,
    "triangle_count directed": lambda sh, m: ring.triangle_count(sh, m, directed=True),
    "triangle_count_sparse": ring.triangle_count_sparse,
    "jaccard_weights": ring.jaccard_weights,
    "jaccard_weights_sparse": ring.jaccard_weights_sparse,
    "jaccard_flat": ring.jaccard_flat,
    "_sparse_sizes": ring._sparse_sizes,
}


def ring_graph(gen, dev, n, pairs, repeats=0, loops=0):
    """Random pairs, mirrored, with ``repeats`` of them stored again and
    ``loops`` self-loops: a multiset pattern, rows sorted."""
    u = torch.randint(0, n, (pairs,), generator=gen, device=dev)
    v = torch.randint(0, n, (pairs,), generator=gen, device=dev)
    row, col = torch.cat([u, v, u[:repeats]]), torch.cat([v, u, v[:repeats]])
    at = torch.randint(0, n, (loops,), generator=gen, device=dev)
    row, col = torch.cat([row, at]), torch.cat([col, at])
    return COO.new(row.to(torch.int32), col.to(torch.int32), None, (n, n)).convert(CSR)


@pytest.mark.parametrize("case", ["n=3000", "rows of 8", "multiset"])
@pytest.mark.parametrize("name", sorted(RING_FUNCTIONS))
def test_ring_on_card_equals_cpu(dev, gen, shard_meshes, name, case):
    """Each ring function on a 4-shard card mesh equal to the CPU mesh's:
    counts exactly, weights bit for bit. ``rows of 8``: 32 vertices, the
    dense ring's products on 8-row tiles."""
    from sparsebase_tpu_torch.parallel import ShardedCSR

    card_mesh, cpu_mesh = shard_meshes
    n, pairs, extra = {"n=3000": (3_000, 20_000, {}), "rows of 8": (32, 120, {}),
                       "multiset": (500, 3_000, dict(repeats=400, loops=30))}[case]
    csr = ring_graph(gen, dev, n, pairs, **extra)
    sh, host = ShardedCSR.from_csr(csr, card_mesh, halo=False), ShardedCSR.from_csr(csr.to_host(), cpu_mesh, halo=False)
    got, want = RING_FUNCTIONS[name](sh, card_mesh), RING_FUNCTIONS[name](host, cpu_mesh)
    if isinstance(want, torch.Tensor):
        want = (want,)
        got = (got,)
    if isinstance(want, tuple) and isinstance(want[0], torch.Tensor):
        assert all(g.device == dev and torch.equal(g.cpu(), w) for g, w in zip(got, want)), name
    else:
        assert got == want, name


def test_ring_dense_counts_are_exact_on_card(dev, shard_meshes):
    """K_512 on the card's dense ring: C(512, 3) triangles (6·C(512, 3) >
    2^24) and weights of 510/512; a bfloat16 product output would read 510
    as 512."""
    from sparsebase_tpu_torch.parallel import ShardedCSR

    n = 512
    ids = torch.arange(n, device=dev)
    row, col = ids.repeat_interleave(n), ids.repeat(n)
    keep = row != col
    csr = COO.new(row[keep].to(torch.int32), col[keep].to(torch.int32), None, (n, n)).convert(CSR)
    card_mesh = shard_meshes[0]
    sh = ShardedCSR.from_csr(csr, card_mesh, halo=False)
    assert ring.triangle_count(sh, card_mesh) == n * (n - 1) * (n - 2) // 6
    assert ring.triangle_count(sh, card_mesh, directed=True) == n * (n - 1) * (n - 2) // 3
    flat = ring.jaccard_flat(sh, card_mesh)
    assert flat.device == dev and bool((flat == torch.tensor(510 / 512, dtype=torch.float32)).all())


def test_ppermute_on_shared_devices_returns_the_tensors(dev):
    from sparsebase_tpu_torch.parallel import collectives

    parts = [torch.full((4,), k, device=dev) for k in range(4)]
    got = collectives.ppermute(parts, [(j, (j - 1) % 4) for j in range(4)])
    assert all(g is parts[(k + 1) % 4] for k, g in enumerate(got))
    moved = collectives.ppermute([parts[0], torch.zeros(4)], [(0, 1), (1, 0)])
    assert moved[1].device.type == "cpu" and torch.equal(moved[1], parts[0].cpu()) and moved[0].device == dev


def test_bench_suite_run_distributed_on_card_equals_cpu(dev, monkeypatch):
    """``run_distributed(shards=4)`` on a graph of 1,000 vertices (the ring
    block runs): every field but the times equal to the CPU call's."""
    from sparsebase_tpu_torch import bench_suite

    monkeypatch.setitem(bench_suite.MATRICES, "rand-20k",
                        lambda device: bench_suite.synthetic_graph(1_000, 6, device=device))
    card = bench_suite.run_distributed(shards=4)
    host = bench_suite.run_distributed(device="cpu", shards=4)

    def without_times(e):
        if isinstance(e, dict):
            return {k: without_times(v) for k, v in e.items() if k != "seconds"}
        return e

    assert without_times(card) == without_times(host)
    assert card["rand-20k"]["ring_mxu"]["triangles_match_host"] and card["rand-20k"]["ring_mxu"]["jaccard_match_host"]


def _group_on_card(tmp_path, backend: str, per_process: int):
    """Two processes of ``tests/torch_multiproc_child.py`` on the card(s):
    each rank's saved results."""
    import sys

    import torch_multiproc_child as child
    from sparsebase_tpu_torch.parallel import multihost

    multihost.launch([sys.executable, child.__file__, "--out", str(tmp_path), "--device", "cuda", "--shards",
                      str(per_process), "--backend", backend], 2, timeout=300)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]


def _assert_group_equals_one_process(ranks, per_process, mesh, dev):
    """Every rank's shards and replicated results, the ingest's path's, the
    functions' (``child.FUNCTIONS``) and the multilevel calls'
    (``child.MULTILEVEL``, containers shard by shard, the same error where
    the one process's call raises), with their ``stats``, equal the
    single-process ``mesh``'s bit for bit."""
    import torch_multiproc_child as child
    from test_torch_multiproc import assert_result

    for graph in child.GRAPHS:
        want = child.run_path(mesh, graph, dev)
        for res in ranks:
            got = res[per_process][graph]
            for name in child.FIELDS:
                for k, (g, w) in enumerate(zip(got[name], want[name])):
                    if g is not None:
                        assert g.dtype == w.dtype and torch.equal(g.to(w.device), w), (graph, name, k)
            for name in ("stats", "nnz_counts", "nnz", "width", "halo_width", "halo_bytes"):
                assert got[name] == want[name], (graph, name)
            for name in ("y", "order", "levels", "degrees", "degree_order"):
                assert torch.equal(got[name].to(want[name].device), want[name]), (graph, name)
        want = child.run_functions(mesh, graph, dev)
        for res in ranks:
            for name, (result, stats) in res[per_process]["functions"][graph].items():
                want_result, want_stats = want[name]
                pairs = [(result[k], want_result[k]) for k in want_result] if isinstance(want_result, dict) else \
                    [(result, want_result)]
                for g, w in pairs:
                    assert g.dtype == w.dtype and torch.equal(g.to(w.device), w), (graph, name)
                assert stats == want_stats, (graph, name)
        want = child.run_multilevel(mesh, graph, dev)
        for res in ranks:
            local = res[per_process]["mesh"][1]
            for name, (result, stats) in res[per_process]["multilevel"][graph].items():
                want_result, want_stats = want[name]
                assert_result(result, want_result, local, f"{graph} {name}")
                assert stats == want_stats, (graph, name)


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    """Two gloo processes of two shards each sharing the card, once."""
    return _group_on_card(tmp_path_factory.mktemp("gloo"), "gloo", 2)


def test_two_gloo_processes_sharing_the_card_equal_one_process(gloo_ranks, dev):
    from sparsebase_tpu_torch.parallel import make_mesh

    assert [r["backend"] for r in gloo_ranks] == ["gloo", "gloo"]
    assert all(r[2]["traffic"]["staged_bytes"] > 0 for r in gloo_ranks)  # gloo stages the card's tensors
    _assert_group_equals_one_process(gloo_ranks, 2, make_mesh(devices=[dev] * 4), dev)


def test_two_gloo_processes_rings_equal_one_process(gloo_ranks, dev):
    """The rings of ``child.RING`` on both graphs (the dense ring's bfloat16
    tiles cross the processes) equal one process of four card shards."""
    import torch_multiproc_child as child
    from test_torch_multiproc import assert_ring

    from sparsebase_tpu_torch.parallel import make_mesh

    for graph in child.GRAPHS:
        want = child.run_ring(make_mesh(devices=[dev] * 4), graph, dev)
        for res in gloo_ranks:
            for name, w in want.items():
                assert_ring(res[2]["ring"][graph][name], w, res[2]["mesh"][1], f"{graph} {name}")


def test_two_gloo_processes_sharded2d_and_containers_equal_one_process(gloo_ranks, dev):
    """``sharded2d`` on ``global_mesh_2d((2, 2))`` in both orientations,
    ``ShardedCSR.stacked`` and ``to`` equal one process of the card."""
    import torch_multiproc_child as child
    from test_torch_multiproc import assert_container

    from sparsebase_tpu_torch.parallel import make_mesh, make_mesh_2d

    for graph in child.GRAPHS:
        want = child.run_containers(make_mesh(devices=[dev] * 4), make_mesh_2d((2, 2), devices=[dev] * 4), graph,
                                    dev)
        for rank, res in enumerate(gloo_ranks):
            for name, w in want.items():
                assert_container(res[2]["containers"][graph][name], w, name, 2, rank, f"{graph} {name}")


@pytest.mark.skipif("torch.cuda.device_count() < 2", reason="the NCCL route needs a card a process, two cards")
def test_two_nccl_processes_a_card_each_equal_one_process(tmp_path, dev):
    from sparsebase_tpu_torch.parallel import make_mesh

    ranks = _group_on_card(tmp_path, "nccl", 2)
    assert [r["backend"] for r in ranks] == ["nccl", "nccl"]
    assert all(r[2]["traffic"]["staged_bytes"] == 0 for r in ranks)
    mesh = make_mesh(devices=[torch.device("cuda", 0)] * 2 + [torch.device("cuda", 1)] * 2)
    _assert_group_equals_one_process(ranks, 2, mesh, dev)


def test_scaling_row_on_the_card():
    from sparsebase_tpu_torch.parallel import scaling

    rows = scaling.run_weak_scaling(base_n=4096, avg_deg=8, device_counts=[2], reps=1, device="cuda", timeout=300)
    want = scaling.run_one_row("random", 2, base_n=4096, avg_deg=8, reps=1, device="cpu")
    got = rows[2]
    assert got["devices"] == (["cuda:0", "cuda:0"] if torch.cuda.device_count() == 1 else ["cuda:0", "cuda:1"])
    for name in ("n", "nnz", "halo_bytes_per_step", "bfs_depth", "rcm_steps"):
        assert got[name] == want[name], name
