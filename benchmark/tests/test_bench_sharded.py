"""The four-card cell ``kron27.sharded_spmv`` through the harness: on the
CPU at scale 10 (four shards on the CPU) the sound program is correct, the
control (the reference in bfloat16) is not, and neither is the program
with one fault underneath: the crossing entries left out of the ingest's
exchange, a halo exchange that delivers zeros, one iteration skipped. On a
host with four cards, the cell at scale 20 reports each of its metrics."""

import time
import weakref

import pytest
import torch

from benchmark.core import harness

CELL = "kron27.sharded_spmv"
CPU = torch.device("cpu")
NEW_METRICS = ("shard_ingest_ms", "halo_build_ms", "halo_exchange_ms", "cross_card_entry_pct", "exchange_link_pct")


@pytest.fixture(autouse=True)
def allow_pytest_plugins(monkeypatch):
    """pytest's plugins may load JAX into this process; a benchmark run's
    own process is checked in test_bench_imports."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])


def run(spec, control=False):
    return harness.run(CELL, 2**31 + 17, 0.05, False, process_start=time.perf_counter(), dev=CPU, spec=spec,
                       overrides={"scale": 10}, control=control)


def failed(line):
    return [name for name, c in line["checks"].items() if c["value"] > c["limit"]]


def test_the_sound_program_is_correct(spec):
    line = run(spec)
    assert line["correct"], line["checks"]
    assert line["entries_per_call"] == 20956 and list(line)[-1] == "checks"


def test_the_control_is_not_correct(spec):
    line = run(spec, control=True)
    assert not line["correct"] and failed(line) == ["x_err"]


def _own_entries_only(monkeypatch):
    """Each shard receives its own entries only, and in place of the others
    copies of its first one, as many as the loads say."""
    from sparsebase_tpu_torch.parallel import sharded

    real = sharded._route_exchange

    def exchange(field, routed, bounds, owners):
        full = real(field, routed, bounds, owners)
        out = []
        for r, got in enumerate(full):
            own = field[r].index_select(0, routed[r][0][bounds[r][2 * r]:bounds[r][2 * r + 1]])
            out.append(torch.cat([own, own[:1].expand(got.numel() - own.numel())]))
        return tuple(out)

    monkeypatch.setattr(sharded, "_route_exchange", exchange)


def _zero_halo(monkeypatch):
    from sparsebase_tpu_torch.parallel import halo

    monkeypatch.setattr(halo, "all_to_all", lambda parts, *a, **k: tuple(torch.zeros_like(p) for p in parts))


def _skipped_iteration(monkeypatch):
    """Each call's first SpMV returns ``x`` times the largest row norm, so
    that the step divided by it leaves ``x`` as it was."""
    from sparsebase_tpu_torch.parallel import halo

    real, seen = halo.spmv, weakref.WeakSet()

    def spmv(sh, x, mesh):
        if sh in seen:
            return real(sh, x, mesh)
        seen.add(sh)
        norm = max(float(torch.zeros((sh.rows_per_shard,), dtype=torch.float64).index_add_(
            0, torch.repeat_interleave(torch.arange(sh.rows_per_shard), torch.diff(ip)),
            v[:cnt].double() ** 2).max()) for ip, v, cnt in zip(sh.indptr, sh.vals, sh.nnz_counts))
        return x * norm ** 0.5

    monkeypatch.setattr(halo, "spmv", spmv)


@pytest.mark.parametrize("fault,check", [(_own_entries_only, "csr_mismatch"), (_zero_halo, "x_err"),
                                         (_skipped_iteration, "x_err")],
                         ids=["crossing-entries-left-out", "zero-halo", "skipped-iteration"])
def test_a_fault_underneath_is_not_correct(spec, monkeypatch, fault, check):
    fault(monkeypatch)
    line = run(spec)
    assert not line["correct"] and check in failed(line), line["checks"]


def test_the_cell_runs_on_four_cards(spec):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    card = torch.device("cuda", 0)
    line = harness.run(CELL, 2**31 + 19, 0.5, False, process_start=time.perf_counter(), dev=card, spec=spec,
                       overrides={"scale": 20})
    assert line["correct"], line["checks"]
    assert {m["name"] for m in spec.end_to_end(CELL)} <= set(line["metrics"])
    traced = harness.run(CELL, 2**31 + 21, 0.5, True, process_start=time.perf_counter(), dev=card, spec=spec,
                         overrides={"scale": 20}, margin_s=0.2)
    assert traced["correct"], traced["checks"]
    assert set(NEW_METRICS) <= set(traced["metrics"])
    assert 0 < traced["metrics"]["exchange_link_pct"]["value"] <= 100
    assert 74 < traced["metrics"]["cross_card_entry_pct"]["value"] < 76
