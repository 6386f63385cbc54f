"""Each cell's comparison, driven through the rest of a run on the CPU at a
tiny size (the look for a card skipped): the sound program passes; the
control, the reference computed in bfloat16 in the program's place, fails;
and so does the program with its timed path broken underneath, once for
each fault the cell can have: a step that returns its state unchanged,
half of the rows left out, an answer altered where it is produced. (One
card: no exchange between chips to leave out.)"""

import importlib
import time

import pytest
import torch

from benchmark.core import harness

CELLS = ("kron.preprocess", "hpcg.preprocess", "kron.partition", "hpcg.dia_solve")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def allow_pytest_plugins(monkeypatch):
    """pytest's plugins may load JAX into this process; a benchmark run's
    own process is checked in test_bench_imports."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])


def run(spec, tiny, workload, control=False):
    return harness.run(workload, 2**31 + 7, 0.05, False, process_start=time.perf_counter(), dev=CPU, spec=spec,
                       overrides=tiny(workload), control=control)


@pytest.mark.parametrize("workload", CELLS)
def test_the_sound_program_is_correct(spec, tiny, workload):
    line = run(spec, tiny, workload)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks" and line["attempted"] >= 1


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(spec, tiny, workload):
    line = run(spec, tiny, workload, control=True)
    assert not line["correct"] and line["failed"] == 1
    failed = [name for name, c in line["checks"].items() if c["value"] > c["limit"]]
    assert failed == (["x_err"] if workload == "hpcg.dia_solve" else ["y_err"])


def _unchanged_permutation(monkeypatch):
    from sparsebase_tpu_torch.models import pipelines

    monkeypatch.setattr(pipelines, "_permute_csr", lambda formats, params: formats[0])


def _unchanged_labels(monkeypatch):
    from sparsebase_tpu_torch.ops.partition import labelprop

    monkeypatch.setattr(labelprop, "_propagate", lambda csr, labels, *a, **k: labels)


def _unchanged_iterate(monkeypatch):
    from sparsebase_tpu_torch.models import pipelines

    monkeypatch.setattr(pipelines, "banded_spmv", lambda dia, x: x * 52.0)


def _wrapped(module, name, alter):
    """Patch ``module.name`` so that ``alter`` changes each output in place."""
    def patch(monkeypatch):
        mod = importlib.import_module(module)
        real = getattr(mod, name)

        def broken(*args, **kwargs):
            out = real(*args, **kwargs)
            alter(out)
            return out

        monkeypatch.setattr(mod, name, broken)
    return patch


def _half_rows(module, name):
    def zero_half(y):
        y[y.numel() // 2:] = 0
    return _wrapped(module, name, zero_half)


def _altered(module, name, pick=lambda out: out):
    def bump(out):
        t = pick(out)
        t[t.numel() // 3] += 1
    return _wrapped(module, name, bump)


PIPE = "sparsebase_tpu_torch.models.pipelines"
FAULTS = {
    "kron.preprocess": {
        "state unchanged": _unchanged_permutation,
        "half the rows": _half_rows(PIPE, "spmv_csr"),
        "answer altered": _altered("sparsebase_tpu_torch.ops.permute", "relocate_csr", lambda csr: csr.indices),
    },
    "hpcg.preprocess": {
        "state unchanged": _unchanged_permutation,
        "half the rows": _half_rows(PIPE, "spmv_csr"),
        "answer altered": _altered(PIPE, "spmv_csr"),
    },
    "kron.partition": {
        "state unchanged": _unchanged_labels,
        "half the rows": _half_rows(PIPE, "spmv_csr"),
        "answer altered": _altered("sparsebase_tpu_torch.ops.partition.labelprop", "label_prop_round"),
    },
    "hpcg.dia_solve": {
        "state unchanged": _unchanged_iterate,
        "half the rows": _half_rows(PIPE, "banded_spmv"),
        "answer altered": _altered(PIPE, "banded_spmv"),
    },
}


@pytest.mark.parametrize("workload,fault", [(w, f) for w in CELLS for f in FAULTS[w]])
def test_a_broken_timed_path_is_not_correct(spec, tiny, monkeypatch, workload, fault):
    FAULTS[workload][fault](monkeypatch)
    line = run(spec, tiny, workload)
    assert not line["correct"], (fault, line["checks"])
