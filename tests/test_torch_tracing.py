"""The port's spans and counters (``sparsebase_tpu_torch/utils/tracing.py``),
on the CPU: the spans each pipeline, conversion and dispatch opens under
``torch.profiler``, their nesting on the host, the null span with no
profiler running, and the table of counters that the kernels' launch
counts read."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sparsebase_tpu_torch import COO, CSR, DIA, _build, preprocess_pipeline, spmv
from sparsebase_tpu_torch.convert import graph
from sparsebase_tpu_torch.models.pipelines import partition_pipeline, preprocess_pipeline_donating, rcm_pipeline
from sparsebase_tpu_torch.ops.kernels import relocate_csr
from sparsebase_tpu_torch.utils import tracing

STAGES = {
    "preprocess": ("indptr", "rank", "spmv", "permute"),
    "partition": ("indptr", "label_prop", "rank", "spmv", "permute"),
    "rcm": ("indptr", "rcm", "spmv", "permute"),
}


def sym_coo(seed=0, n=300, nnz=2_000):
    """A symmetric, row-major-sorted COO with duplicates, and an x."""
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
    row, col = np.r_[r, c], np.r_[c, r]
    order = np.lexsort((col, row))
    row, col = torch.from_numpy(row[order].astype(np.int32)), torch.from_numpy(col[order].astype(np.int32))
    vals = torch.from_numpy(rng.standard_normal(row.numel()).astype(np.float32))
    return COO(row, col, vals, (n, n)), torch.from_numpy(rng.standard_normal(n).astype(np.float32))


def banded_csr(n=200):
    i = torch.arange(n)
    rows, cols = [], []
    for d in (-2, 0, 3):
        ok = (i + d >= 0) & (i + d < n)
        rows.append(i[ok])
        cols.append(i[ok] + d)
    row, col = torch.cat(rows), torch.cat(cols)
    order = torch.argsort(row * n + col)
    row, col = row[order].to(torch.int32), col[order].to(torch.int32)
    return COO(row, col, torch.ones(row.numel()), (n, n)).convert(CSR)


def host_spans(fn):
    """``fn()`` under the profiler: the ``sbtorch:`` spans it opened on the
    host, as ``(start, end, name)`` in order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    evs = [(ev.time_range.start, ev.time_range.end, ev.name) for ev in prof.events() if ev.name.startswith("sbtorch:")]
    return sorted(evs)


def names(spans):
    return [name for _, _, name in spans]


def inside(child, parent):
    return parent[0] <= child[0] and child[1] <= parent[1]


PIPELINES = {
    "preprocess": lambda coo, x: preprocess_pipeline(coo, x),
    "preprocess_donating": lambda coo, x: preprocess_pipeline_donating(coo, x),
    "partition": lambda coo, x: partition_pipeline(coo, x, k=4, num_iters=3),
    "rcm": lambda coo, x: rcm_pipeline(coo, x),
}


@pytest.mark.parametrize("which", sorted(PIPELINES))
def test_pipeline_opens_each_stage_once_inside_its_span(which):
    x = sym_coo()[1]
    spans = host_spans(lambda: [PIPELINES[which](sym_coo()[0], x) for _ in range(2)])
    kind = which.split("_")[0]
    outer = [s for s in spans if s[2] == f"sbtorch:pipeline:{kind}"]
    assert len(outer) == 2
    for call in outer:
        stages = [s for s in spans if s[2].startswith("sbtorch:stage:") and inside(s, call)]
        assert names(stages) == [f"sbtorch:stage:{s}" for s in STAGES[kind]]
    assert all(any(inside(s, call) for call in outer) for s in spans if s[2].startswith("sbtorch:stage:"))


def test_pipeline_spans_leave_the_result_unchanged():
    coo, x = sym_coo(3)
    plain = preprocess_pipeline(coo, x)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = preprocess_pipeline(coo, x)
    assert torch.equal(plain[0].indices, traced[0].indices) and torch.equal(plain[1], traced[1])


def test_convert_to_dia_opens_the_edge_and_its_two_stages():
    csr = banded_csr()
    out = []
    spans = host_spans(lambda: out.append(csr.convert(DIA)))
    assert names(spans) == ["sbtorch:convert:CSR->DIA", "sbtorch:csr_to_dia:offsets", "sbtorch:csr_to_dia:fill"]
    assert inside(spans[1], spans[0]) and inside(spans[2], spans[0]) and spans[1][1] <= spans[2][0]
    assert out[0].offsets.tolist() == [-2, 0, 3]


def test_convert_opens_one_span_per_edge_of_a_chain():
    coo, _ = sym_coo(1)
    spans = host_spans(lambda: coo.convert(DIA))
    edges = [n for n in names(spans) if n.startswith("sbtorch:convert:")]
    assert edges == ["sbtorch:convert:COO->CSR", "sbtorch:convert:CSR->DIA"]


def test_dispatched_conversion_opens_each_edge_span_once():
    coo, x = sym_coo(2)
    spans = host_spans(lambda: spmv(coo, x))
    assert names(spans).count("sbtorch:convert:COO->CSR") == 1
    assert names(spans).count("sbtorch:op:spmv") == 1
    edge = next(s for s in spans if s[2] == "sbtorch:convert:COO->CSR")
    op = next(s for s in spans if s[2] == "sbtorch:op:spmv")
    assert edge[1] <= op[0]


def test_apply_edge_hands_the_context_to_a_context_conversion():
    coo, _ = sym_coo(4)
    seen = []
    edge = graph.ContextConversion(lambda fmt, ctx: seen.append(ctx) or fmt)
    spans = host_spans(lambda: graph.apply_edge(edge, coo, CSR, coo.context))
    assert seen == [coo.context] and names(spans) == ["sbtorch:convert:COO->CSR"]
    spans = host_spans(lambda: graph.move(coo, coo.context))
    assert names(spans) == ["sbtorch:convert:COO:to_context"]


def test_span_is_the_shared_null_context_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    first, second = tracing.span("sbtorch:a"), tracing.span("sbtorch:b")
    assert first is second
    with first:
        with second:  # the null context nests and is reused
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.span("sbtorch:a") is not first


def test_conversion_spans_are_host_ranges_and_stages_record_functions():
    """On the device the profiler gives a kernel to the innermost
    ``record_function``: the conversion's spans are host ranges alone, so a
    caller's span around a conversion keeps its kernels; a pipeline's spans
    are ``record_function``s."""
    csr, (coo, x) = banded_csr(), sym_coo(6)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        csr.convert(DIA)
        preprocess_pipeline(coo, x)
    user = {ev.name: ev.is_user_annotation for ev in prof.events() if ev.name.startswith("sbtorch:")}
    assert not user["sbtorch:convert:CSR->DIA"] and not user["sbtorch:csr_to_dia:offsets"]
    assert not user["sbtorch:csr_to_dia:fill"]
    assert user["sbtorch:pipeline:preprocess"] and user["sbtorch:stage:permute"]
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.host_span("sbtorch:a") is not tracing.span("sbtorch:b")
    assert tracing.host_span("sbtorch:a") is tracing.span("sbtorch:b")  # no profiler: the null context


def test_counters_count_reset_and_copy():
    tracing.reset_counters("test.")
    tracing.count("test.a")
    tracing.count("test.a", 4)
    tracing.count("test.b", 0)
    seen = tracing.counters()
    assert seen["test.a"] == 5 and seen["test.b"] == 0
    seen["test.a"] = 99  # a copy
    assert tracing.counters()["test.a"] == 5
    tracing.reset_counters("test.")
    assert not any(k.startswith("test.") for k in tracing.counters())


def test_reset_counters_clears_everything_without_a_prefix():
    saved = tracing.counters()
    try:
        tracing.count("test.c", 2)
        tracing.reset_counters()
        assert tracing.counters() == {}
    finally:
        for name, n in saved.items():
            tracing.count(name, n)


def test_launch_counts_read_the_counters():
    before = _build.launch_counts()
    assert set(before) == set(_build.KERNELS)
    tracing.count("launch:csr_spmv", 3)
    tracing.count("test.d", 7)
    after = _build.launch_counts()
    assert after["csr_spmv"] == before["csr_spmv"] + 3
    assert all(after[k] == before[k] for k in after if k != "csr_spmv")
    _build.reset_launch_counts()
    assert set(_build.launch_counts().values()) == {0}
    assert tracing.counters()["test.d"] == 7  # only the launch counters reset
    tracing.reset_counters("test.")


def test_cpu_relocation_counts_nothing():
    coo, _ = sym_coo(5)
    csr = coo.convert(CSR)
    before = tracing.counters()
    relocate_csr(csr, torch.randperm(csr.nrows).to(torch.int32), None)
    after = tracing.counters()
    assert {k: v for k, v in after.items() if k.startswith("relocate.")} == {
        k: v for k, v in before.items() if k.startswith("relocate.")}
