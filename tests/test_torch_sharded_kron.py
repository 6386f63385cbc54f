"""GAP's kron graph in blocks through the distributed tier, on a mesh of
four CPU shards at scale 10: ``ShardedCSR.from_coo_blocks`` on the blocks
of ``benchmark/gen/kronecker_sharded.py`` against the plain reference
(``benchmark/reference/sharded.py``) and against ``from_coo_sharded`` of
the joined entries; the 20th iterate of ``halo.spmv`` over the largest row
norm against the float64 iterate; the generator's blocks against
``kronecker.py``'s graph; and the ingest's spans and counters."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.core.spec import Spec
from benchmark.gen import kronecker, kronecker_sharded
from benchmark.reference import sharded as ref
from sparsebase_tpu_torch.parallel import ShardedCSR, halo, make_mesh
from sparsebase_tpu_torch.parallel import sharded as port_sharded
from sparsebase_tpu_torch.utils import tracing

SEED = 2**31 + 11  # past 32 signed bits, as a run's seed may be
ITERATIONS = 20
# The 20th iterate in float32 against float64: each step rounds every
# product and every partial sum of a row (at most 471 entries here) once,
# a relative 6e-8 a rounding; over 20 steps the widest gap reads 6.3e-7 of
# the iterate's largest magnitude (2**31 + 7, harness run on the CPU). The
# bfloat16 iterate reads 4e-2.
X_TOL = 1e-4


@pytest.fixture(scope="module")
def cfg():
    return dict(Spec().config("gap-kron-s27"), scale=10)


@pytest.fixture(scope="module")
def graph(cfg):
    return kronecker_sharded.make(cfg, SEED, torch.device("cpu"))


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(devices=["cpu"] * 4)


def ingest(graph, mesh, stats=None):
    n = graph["n"]
    return ShardedCSR.from_coo_blocks(graph["rows"], graph["cols"], graph["vals"], (n, n), mesh, stats=stats)


def test_blocks_are_kroneckers_graph_dealt(cfg, graph):
    """The union of the blocks is ``kronecker.py``'s graph from the same
    settings, as a set of entries; each block holds a quarter (to one
    entry) of every row block's entries, and not in row order."""
    want = kronecker.make(dict(Spec().config("gap-kron-s25"), scale=10), SEED, torch.device("cpu"))
    n = graph["n"]

    def keys(row, col, vals):
        return torch.sort((row.long() * n + col.long()) * 256 + vals.long()).values

    got = keys(torch.cat(graph["rows"]), torch.cat(graph["cols"]), torch.cat(graph["vals"]))
    assert torch.equal(got, keys(want["row"], want["col"], want["vals"]))
    assert torch.equal(graph["x"], want["x"])
    rb = n // 4
    per_block = torch.bincount(torch.cat(graph["rows"]).long() // rb, minlength=4)
    for rows in graph["rows"]:
        mine = torch.bincount(rows.long() // rb, minlength=4)
        assert ((mine - per_block / 4).abs() <= 1).all()
        assert not bool((rows[1:] >= rows[:-1]).all())


def test_ingest_equals_the_reference_bit_for_bit(graph, mesh):
    sh = ingest(graph, mesh)
    n = graph["n"]
    args = (graph["rows"], graph["cols"], graph["vals"])
    for k in range(4):
        ip, cols, vals = ref.rows_csr(*args, k * n // 4, (k + 1) * n // 4, n, torch.device("cpu"))
        cnt = sh.nnz_counts[k]
        assert torch.equal(sh.indptr[k], ip)
        assert torch.equal(sh.indices[k][:cnt], cols)
        assert torch.equal(sh.vals[k][:cnt].view(torch.int32), vals.view(torch.int32))
    got = {"indptr": list(sh.indptr), "cols": [c[:k] for c, k in zip(sh.indices, sh.nnz_counts)],
           "vals": [v[:k] for v, k in zip(sh.vals, sh.nnz_counts)]}
    assert ref.csr_mismatches(got, *args, n, n) == 0


def test_ingest_equals_from_coo_sharded_of_the_joined_entries(graph, mesh):
    """Field for field, after ``with_halo`` too."""
    n = graph["n"]
    blocks = ingest(graph, mesh).with_halo()
    joined = ShardedCSR.from_coo_sharded(torch.cat(graph["rows"]), torch.cat(graph["cols"]), torch.cat(graph["vals"]),
                                         (n, n), mesh).with_halo()
    assert blocks.nnz_counts == joined.nnz_counts and blocks.width == joined.width
    for name in ShardedCSR._FIELDS:
        assert torch.equal(blocks.stacked(name), joined.stacked(name)), name


def test_iterate_is_within_its_tolerance_and_bfloat16_is_not(graph, mesh):
    n = graph["n"]
    args = (graph["rows"], graph["cols"], graph["vals"])
    scale = ref.largest_row_norm(*args, n, torch.device("cpu"))
    sh = ingest(graph, mesh).with_halo()
    x = graph["x"]
    for _ in range(ITERATIONS):
        x = halo.spmv(sh, x, mesh) / scale
    want = ref.iterate(*args, graph["x"], n, ITERATIONS, scale)
    assert ref.iterate_gap(x, want) <= X_TOL
    low = ref.iterate(*args, graph["x"], n, ITERATIONS, scale, torch.bfloat16)
    assert ref.iterate_gap(low.float(), want) > X_TOL
    # one step more or fewer is far outside it
    assert ref.iterate_gap(ref.iterate(*args, graph["x"], n, ITERATIONS - 1, scale), want) > 100 * X_TOL


def test_spans_and_counters_add_no_host_read(graph, mesh, monkeypatch):
    """The ingest opens ``sbtorch:shard:ingest`` with ``:route``,
    ``:exchange`` and ``:local`` inside it; ``with_halo`` opens
    ``sbtorch:shard:halo`` with one ``sbtorch:halo:exchange`` inside it, and
    each SpMV one of its own. The counters take the routed and crossing
    entries from the loads the ingest reads back: the host reads are the
    two that ``stats`` counts, and ``with_halo``'s one."""
    reads = []
    real = port_sharded.host_fetch
    monkeypatch.setattr(port_sharded, "host_fetch", lambda *a, **k: reads.append(1) or real(*a, **k))
    tracing.reset_counters()
    stats = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sh = ingest(graph, mesh, stats)
        ingest_reads = len(reads)
        sh = sh.with_halo()
        halo.spmv(sh, graph["x"], mesh)
    assert ingest_reads == stats["host_reads"] == 2 and len(reads) == 3
    spans = sorted((ev.time_range.start, ev.time_range.end, ev.name) for ev in prof.events()
                   if ev.name.startswith("sbtorch:shard:") or ev.name.startswith("sbtorch:halo:"))
    names = [s[2] for s in spans]
    assert names == ["sbtorch:shard:ingest", "sbtorch:shard:route", "sbtorch:shard:exchange", "sbtorch:shard:local",
                     "sbtorch:shard:halo", "sbtorch:halo:exchange", "sbtorch:halo:exchange"]
    outer = {name: s for s, name in zip(spans, names) if name in ("sbtorch:shard:ingest", "sbtorch:shard:halo")}
    for s in spans[1:4]:
        assert outer["sbtorch:shard:ingest"][0] <= s[0] and s[1] <= outer["sbtorch:shard:ingest"][1]
    assert outer["sbtorch:shard:halo"][0] <= spans[5][0] and spans[5][1] <= outer["sbtorch:shard:halo"][1]
    n, rb = graph["n"], graph["n"] // 4
    routed = sum(r.numel() for r in graph["rows"])
    crossed = sum(int((rows.long() // rb != k).sum()) for k, rows in enumerate(graph["rows"]))
    seen = tracing.counters()
    assert seen["shard.routed_entries"] == routed and seen["shard.crossed_entries"] == crossed
    assert 0.7 < crossed / routed < 0.8
    # the shards share the CPU: nothing crosses from one card to another
    assert seen.get("collectives.card_bytes", 0) == 0
    tracing.reset_counters()


@pytest.mark.parametrize("pattern", [False, True], ids=["valued", "pattern"])
def test_ingest_of_blocks_with_pads_and_duplicates(pattern):
    """Blocks of unequal lengths with duplicate coordinates and rows at and
    past n (dropped), and a pattern without values: each shard equals the
    reference's row block, duplicates in the order of the blocks joined."""
    rng = np.random.default_rng(3)
    n, d = 37, 4
    sizes = [0, 55, 140, 9]
    rows = [torch.as_tensor(rng.integers(0, n + 8, s), dtype=torch.int32) for s in sizes]
    cols = [torch.as_tensor(rng.integers(0, 12, s), dtype=torch.int32) for s in sizes]
    vals = [torch.as_tensor(rng.standard_normal(s), dtype=torch.float32) for s in sizes]
    mesh = make_mesh(devices=["cpu"] * d)
    stats = {}
    sh = ShardedCSR.from_coo_blocks(rows, cols, None if pattern else vals, (n, n), mesh, stats=stats)
    assert (sh.vals is None) == pattern
    rb = ref.row_block(n, d)
    for k in range(d):
        lo, hi = k * rb, min((k + 1) * rb, n)
        ip, c, v = ref.rows_csr(rows, cols, vals, lo, hi, n, torch.device("cpu"))
        cnt = sh.nnz_counts[k]
        assert torch.equal(sh.indptr[k][: hi - lo + 1], ip) and torch.equal(sh.indices[k][:cnt], c)
        assert bool((sh.indices[k][cnt:] == 0).all()) and sh.width == stats["compacted_width"]
        if not pattern:
            assert torch.equal(sh.vals[k][:cnt], v)
    assert sh.nnz == sum(int((r < n).sum()) for r in rows)
