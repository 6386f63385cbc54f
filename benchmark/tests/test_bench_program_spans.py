"""The readers of the program's spans and counters, on synthetic traces:
each reads its span's device time, reads nothing where the span never
reached the device, and the idle share keeps to the program's own spans."""

import pytest

from benchmark.core.bounds import roofline_pct
from benchmark.core.spec import Spec
from benchmark.core.trace import Trace

SPAN_READERS = {  # reader -> the span whose device time per call it reports, in ms
    "long_row_ms": "sbtorch:relocate:long_rows",
}
SHAPES = {"n": 1_000, "ncols": 1_000, "nnz": 20_000}


def reader(name):
    return Spec().module("metrics", name)


def trace(kernels, annotations=(), host=(), window=(0.0, 100.0), calls=2):
    return Trace(calls, window, sorted(kernels), sorted(annotations), list(host))


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_a_span_reader_reads_its_device_time_per_call(name):
    span = SPAN_READERS[name]
    tr = trace([(0.0, 10.0, "a"), (12.0, 20.0, "b"), (30.0, 40.0, "c"), (50.0, 54.0, "d")],
               annotations=[(5.0, 25.0, span), (50.0, 54.0, span), (30.0, 40.0, "sbtorch:other")])
    assert reader(name).read(tr, SHAPES) == pytest.approx(1e3 * 17e-6 / 2)


@pytest.mark.parametrize("name", sorted(SPAN_READERS) + ["permute_roofline"])
def test_a_span_reader_reads_nothing_where_its_span_never_reached_the_device(name):
    host = [(0.0, 50.0, SPAN_READERS.get(name, "sbtorch:stage:permute"))]  # opened on the host, no kernel in it
    tr = trace([(0.0, 10.0, "a")], annotations=[(0.0, 10.0, "sbtorch:stage:spmv")], host=host)
    assert reader(name).read(tr, SHAPES) is None


def dia_trace(calls=1):
    """A conversion inside the caller's span (device range 10-90, inside a
    longer one): offsets' kernels at 10-20 and 25-30, the host read, the
    host entering ``fill`` at 40, fill's kernels at 50-85."""
    kernels = [(10.0, 20.0, "k"), (25.0, 30.0, "unique"), (50.0, 85.0, "index_put"), (95.0, 99.0, "spmv")]
    annotations = [(10.0, 90.0, "bench:convert:CSR->DIA"), (0.0, 100.0, "outer"), (95.0, 99.0, "sbtorch:op:spmv")]
    host = [(5.0, 60.0, "sbtorch:convert:CSR->DIA"), (6.0, 38.0, "sbtorch:csr_to_dia:offsets"),
            (40.0, 58.0, "sbtorch:csr_to_dia:fill")]
    return trace(kernels, annotations, host, calls=calls)


def test_the_dia_stages_split_the_callers_device_range_where_fill_begins():
    assert reader("dia_offsets_ms").read(dia_trace(), SHAPES) == pytest.approx(1e3 * 15e-6)
    assert reader("dia_fill_ms").read(dia_trace(), SHAPES) == pytest.approx(1e3 * 35e-6)
    assert reader("dia_offsets_ms").read(dia_trace(calls=5), SHAPES) == pytest.approx(1e3 * 3e-6)


@pytest.mark.parametrize("name", ["dia_offsets_ms", "dia_fill_ms"])
def test_the_dia_stages_read_nothing_outside_a_device_range(name):
    tr = dia_trace()
    assert reader(name).read(trace(tr.kernels, [], tr.host_ops), SHAPES) is None  # no span around on the device
    assert reader(name).read(trace(tr.kernels, tr.annotations, tr.host_ops[:1]), SHAPES) is None  # no stage span


def test_permute_roofline_takes_the_spans_nested_in_the_stage():
    """The stage's own device range ends at K4; the long-row route, in a
    span of its own inside the stage on the host, adds its range."""
    host = [(0.0, 40.0, "sbtorch:stage:permute"), (20.0, 38.0, "sbtorch:relocate:long_rows"),
            (41.0, 60.0, "sbtorch:stage:spmv")]
    kernels = [(10.0, 30.0, "relocate_block_rows"), (35.0, 45.0, "radix_pass"), (50.0, 70.0, "csr_spmv_tiles")]
    annotations = [(10.0, 30.0, "sbtorch:stage:permute"), (35.0, 45.0, "sbtorch:relocate:long_rows"),
                   (50.0, 70.0, "sbtorch:stage:spmv")]
    tr = trace(kernels, annotations, host, calls=1)
    want = roofline_pct("relocate_csr", 30e-6, n=SHAPES["n"], nnz=SHAPES["nnz"], order_entries=SHAPES["n"],
                        value_bytes=4)
    assert reader("permute_roofline").read(tr, SHAPES) == pytest.approx(want)
    assert reader("permute_roofline").read(trace(kernels, annotations[:1], host, calls=1), SHAPES) == pytest.approx(
        want * 30 / 20)


def test_program_idle_share_keeps_to_the_programs_spans():
    """Idle 20-30 falls inside the pipeline's span; 45-50 inside it too, but
    under the profiler's buffer request; 60-80 after the span (the
    harness's synchronise and loop)."""
    kernels = [(0.0, 20.0, "k"), (30.0, 45.0, "k"), (50.0, 60.0, "k"), (80.0, 100.0, "k")]
    host = [(5.0, 55.0, "sbtorch:pipeline:preprocess"), (10.0, 52.0, "sbtorch:stage:permute"),
            (22.0, 26.0, "aten::item"), (44.0, 51.0, "Activity Buffer Request"), (58.0, 95.0, "cudaDeviceSynchronize")]
    tr = trace(kernels, host=host)
    assert reader("program_idle_pct").read(tr, None) == pytest.approx(10.0)
    idle = reader("device_idle_pct").read(tr, None)
    assert idle == pytest.approx(35.0) and reader("program_idle_pct").read(tr, None) <= idle


def test_program_idle_share_reads_nothing_without_a_program_span():
    tr = trace([(0.0, 20.0, "k")], host=[(0.0, 100.0, "aten::mm")])
    assert reader("program_idle_pct").read(tr, None) is None


@pytest.fixture
def relocate_counters():
    from sparsebase_tpu_torch.utils import tracing

    saved = {k: v for k, v in tracing.counters().items() if k.startswith("relocate.")}
    tracing.reset_counters("relocate.")
    yield tracing
    tracing.reset_counters("relocate.")
    for name, n in saved.items():
        tracing.count(name, n)


def test_long_row_entry_share_reads_the_counters(relocate_counters):
    tr = trace([(0.0, 10.0, "a")])
    assert reader("long_row_entry_pct").read(tr, SHAPES) is None  # nothing relocated on the card
    for _ in range(3):  # the same matrix each call: the share does not depend on the calls
        relocate_counters.count("relocate.entries", 4_000)
        relocate_counters.count("relocate.long_rows", 2)
        relocate_counters.count("relocate.long_row_entries", 1_000)
    assert reader("long_row_entry_pct").read(tr, SHAPES) == pytest.approx(25.0)
    relocate_counters.reset_counters("relocate.long_row")
    assert reader("long_row_entry_pct").read(tr, SHAPES) == 0.0  # no row over the block tier
