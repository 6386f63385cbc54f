"""A configuration, a traffic mix and a per-layer metric are added as new
files and new entries of BENCHMARK.json alone: the harness finds, loads and
runs them by name, with no existing file edited. And the names, units and
keys of BENCHMARK.json keep to the benchmark's rules."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.core.spec import Spec, SpecError

ROOT = Path(__file__).resolve().parents[2]


def copy_benchmark(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest() for p in root.rglob("*") if p.is_file()}


def test_a_new_configuration_mix_and_metrics_need_no_edit(tmp_path):
    root = copy_benchmark(tmp_path)
    before = digests(root)
    bench = root / "benchmark"
    kron = json.loads((bench / "configs" / "gap-kron-s25.json").read_text())
    kron.update(scale=8, reduced={"scale": {"published": 27, "here": 8, "why": "a test's size"}})
    (bench / "configs" / "gap-kron-s8.json").write_text(json.dumps(kron))
    (bench / "traffic" / "preprocess_light.json").write_text(json.dumps(
        {"call": "preprocess_pipeline"}))
    (bench / "metrics" / "traced_calls.py").write_text(
        '"""Calls in the traced window."""\n\n\ndef read(trace, shapes):\n    return float(trace.calls)\n')
    (bench / "e2e" / "call_ms_max.py").write_text(
        '"""The slowest call of the window."""\n\n\ndef read(window):\n    return 1e3 * max(window.call_s)\n')
    (bench / "limits" / "kron8.light.json").write_text(json.dumps({"limits": {"csr_mismatch": 0, "y_err": 1e-4}}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "gap-kron-s8", "source": "https://arxiv.org/abs/1508.03619",
                            "file": "benchmark/configs/gap-kron-s8.json", "reduced": ["scale"], "why": "a test"})
    spec["workloads"].append({"name": "kron8.light", "config": "gap-kron-s8", "traffic": "preprocess_light",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "call_ms_max", "unit": "ms", "better": "lower", "bound": 0.25,
                               "source": "host_clock", "workloads": ["kron8.light"]})
    spec["per_layer"].append({"name": "traced_calls", "unit": "calls", "better": "higher",
                              "source": "program_counter", "layer": "host", "moves": "nnz_per_s",
                              "workloads": ["kron8.light"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = digests(root)
    assert all(after[p] == h for p, h in before.items() if p.name != "BENCHMARK.json")
    code = (
        "import sys, json, time, torch\n"
        f"sys.path[:0] = [{str(root)!r}, {str(ROOT)!r}]\n"
        "from benchmark.core import harness\n"
        "from benchmark.core.spec import Spec\n"
        "spec = Spec(); spec.validate()\n"
        "assert str(spec.root) == sys.path[0], spec.root\n"
        "for traced in (False, True):\n"
        "    line = harness.run('kron8.light', 11, 0.1, traced, process_start=time.perf_counter(),\n"
        "                       dev=torch.device('cpu'), spec=spec, margin_s=0.0)\n"
        "    print(json.dumps({'correct': line['correct'], 'metrics': sorted(line['metrics'])}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr
    untraced, traced = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert untraced == {"correct": True, "metrics": ["call_ms_max", "nnz_per_s", "setup_s"]}  # no card: no memory
    assert traced == {"correct": True, "metrics": ["traced_calls"]}  # no card: no device trace


def test_the_benchmark_keeps_to_its_rules():
    spec = Spec(ROOT)
    spec.validate()
    d = spec.data
    assert d["command"] == ["python3", "benchmark/run.py"] and d["paths"] == ["benchmark"]
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in d["end_to_end"])
    for m in d["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for cell in d["workloads"]:
        assert spec.end_to_end(cell["name"]) and spec.per_layer(cell["name"])
        assert len(spec.end_to_end(cell["name"])) >= 2
    assert len(json.dumps(d)) <= 64 * 1024


@pytest.mark.parametrize("group,field,bad", [
    ("workloads", "name", "kron preprocess"),
    ("configs", "name", "gap/kron"),
    ("per_layer", "unit", "tokens per second"),
    ("end_to_end", "name", "μs_total"),
    ("workloads", "why", "two\nlines"),
])
def test_bad_names_and_units_are_refused(tmp_path, group, field, bad):
    root = copy_benchmark(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec[group][0][field] = bad
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    with pytest.raises(SpecError):
        Spec(root).validate()


def test_an_unknown_key_is_refused(tmp_path):
    root = copy_benchmark(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"][0]["why"] = "a metric may not carry one"
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    with pytest.raises(SpecError):
        Spec(root).validate()
