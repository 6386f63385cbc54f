"""The yardstick's arithmetic against hand counts: bytes and operations at
each configuration's shapes, the idle share and the breakdown from
synthetic spans, throughput, and the kernel table."""

import re
from pathlib import Path

import pytest

from benchmark.core import bounds, stats
from benchmark.core.trace import Trace, breakdown, device_busy, kernel_table, union_us

KRON_N, HPCG_N = 2**25, 256**3
KRON_NNZ, HPCG_NNZ = 1_048_000_000, 449_455_096


def test_bound_bytes_at_the_configurations_shapes():
    # K4: indptr, ids, values in and out, one order of n int32
    assert bounds.bound_bytes("relocate_csr", n=KRON_N, nnz=KRON_NNZ, order_entries=KRON_N, value_bytes=4) == (
        2 * (8 * (KRON_N + 1) + 8 * KRON_NNZ) + 4 * KRON_N)
    # K2: indptr, ids, values, x in; y out
    assert bounds.bound_bytes("csr_spmv", n=HPCG_N, ncols=HPCG_N, nnz=HPCG_NNZ) == (
        8 * (HPCG_N + 1) + 8 * HPCG_NNZ + 4 * HPCG_N + 4 * HPCG_N)
    assert bounds.bound_ops("csr_spmv", n=HPCG_N, ncols=HPCG_N, nnz=HPCG_NNZ) == 2 * HPCG_NNZ
    # K1: a float32 band of 27 diagonals, the offsets, x in; y out
    assert bounds.bound_bytes("banded_spmv", ndiag=27, n=HPCG_N, m=HPCG_N, band_bytes=4) == (
        27 * HPCG_N * 4 + 4 * 27 + 8 * HPCG_N)
    assert bounds.bound_ops("banded_spmv", ndiag=27, n=HPCG_N) == 54 * HPCG_N
    # K7: indptr, ids, labels in; labels out; an add per entry, a subtraction per cell
    assert bounds.bound_bytes("label_prop", n=KRON_N, nnz=KRON_NNZ) == 8 * (KRON_N + 1) + 4 * KRON_NNZ + 8 * KRON_N
    assert bounds.bound_ops("label_prop", n=KRON_N, nnz=KRON_NNZ, k=8) == KRON_NNZ + 8 * KRON_N
    assert bounds.bound_bytes("indptr", nnz=HPCG_NNZ, nrows=HPCG_N) == 4 * HPCG_NNZ + 8 * (HPCG_N + 1)


def test_bound_takes_the_larger_of_bytes_and_operations():
    seconds, by = bounds.bound("csr_spmv", n=HPCG_N, ncols=HPCG_N, nnz=HPCG_NNZ)
    assert by == "bytes" and seconds == pytest.approx(bounds.bound_bytes(
        "csr_spmv", n=HPCG_N, ncols=HPCG_N, nnz=HPCG_NNZ) / 3.35e12)
    assert bounds.roofline_pct("csr_spmv", 2 * seconds, n=HPCG_N, ncols=HPCG_N, nnz=HPCG_NNZ) == pytest.approx(50.0)
    assert bounds.roofline_pct("csr_spmv", 0.0, n=1, ncols=1, nnz=1) is None


def trace(kernels, window=(0.0, 100.0), host=(), annotations=(), calls=2):
    return Trace(calls, window, sorted(kernels), sorted(annotations), list(host))


def test_busy_and_idle_share_from_synthetic_spans():
    # two overlapping kernels, a gap, one kernel partly outside the window
    tr = trace([(10.0, 30.0, "a"), (20.0, 40.0, "b"), (60.0, 70.0, "c"), (95.0, 120.0, "d")])
    assert tr.busy_s() == pytest.approx((30 + 10 + 5) / 1e6)
    assert tr.window_s == pytest.approx(100 / 1e6)
    assert device_busy([(0, 10, "a"), (5, 8, "b"), (12, 15, "c")]) == (13, [(2, "a", "c")])
    assert union_us([(0, 10, "a"), (5, 20, "b")], 8, 12) == 4
    from benchmark.core.spec import Spec

    idle = Spec().module("metrics", "device_idle_pct").read(tr, None)
    assert idle == pytest.approx(55.0)


def test_breakdown_names_gaps_by_the_innermost_host_operation():
    host = [(0.0, 100.0, "outer"), (40.0, 60.0, "aten::item"), (72.0, 90.0, "aten::nonzero")]
    tr = trace([(0.0, 40.0, "k1"), (60.0, 70.0, "k2"), (90.0, 100.0, "k1")], host=host)
    b = breakdown(tr)
    assert b["device_ops"] == [["k1", pytest.approx(50e-6)], ["k2", pytest.approx(10e-6)]]
    assert b["idle_gaps"] == [["aten::item", pytest.approx(20e-6)], ["aten::nonzero", pytest.approx(20e-6)]]


def test_throughput_is_all_work_over_all_time():
    w = stats.Window([0.5, 0.25, 0.25], 1.25, 1000, 3.0, None, 0)
    assert stats.throughput(w.work_per_call, len(w.call_s), w.wall_s) == pytest.approx(2400.0)
    from benchmark.core.spec import Spec

    assert Spec().module("e2e", "nnz_per_s").read(w) == pytest.approx(2400.0)
    assert Spec().module("e2e", "peak_mem_gib").read(w) is None
    w.peak_bytes, w.base_bytes = 3 * 2**30, 2**30
    assert Spec().module("e2e", "peak_mem_gib").read(w) == pytest.approx(2.0)


def test_kernel_table_holds_every_kernel_of_the_port():
    src = Path(__file__).resolve().parents[2] / "sparsebase_tpu_torch" / "csrc"
    declared = set()
    for cu in src.glob("*.cu"):
        text = cu.read_text()
        declared |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(", text))
    listed = {name for entry in kernel_table().values() for name in entry["kernels"]}
    assert listed == declared
    for entry in kernel_table().values():
        assert entry["bound"] in ("banded_spmv", "csr_spmv", "indptr", "relocate_csr", "radix_rank",
                                  "common_neighbors", "label_prop")


def test_kernel_time_by_class_matches_whole_names():
    k4 = "void (anonymous namespace)::relocate_block_rows<1>(long const*, int const*)"
    k5 = "void (anonymous namespace)::radix_pass<unsigned long>((anonymous namespace)::Buffers<unsigned long>)"
    other = "void at::native::vectorized_elementwise_kernel<2, relocate_block_rows_like>(int)"
    tr = trace([(0.0, 10.0, k4), (10.0, 13.0, k5), (20.0, 22.0, other), (30.0, 34.0, k4)])
    assert tr.kernel_s("K4") == pytest.approx(14e-6)
    assert tr.kernel_s("K5") == pytest.approx(3e-6)
    assert tr.kernel_s("K2") == 0


def test_kernel_time_inside_a_span():
    tr = trace([(0.0, 10.0, "a"), (12.0, 20.0, "b"), (30.0, 40.0, "c")],
               annotations=[(5.0, 25.0, "bench:convert:CSR->DIA")])
    assert tr.inside_s("bench:convert:CSR->DIA") == pytest.approx(13e-6)
    assert tr.inside_s("bench:spmv") is None
