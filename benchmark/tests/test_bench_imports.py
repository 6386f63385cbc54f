"""What the benchmark imports: never JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and from
the plain reference nothing of the port."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "sparsebase_tpu"}


def imported_top_names(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources():
    return sorted(BENCH.rglob("*.py"))


def test_no_module_imports_jax_or_the_jax_package():
    assert sources()
    for path in sources():
        assert not imported_top_names(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        names = imported_top_names(path)
        assert "sparsebase_tpu_torch" not in names and "benchmark" not in names, path
        assert "sparsebase_tpu_torch" not in path.read_text(), path


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    from benchmark.core import harness

    monkeypatch.setattr(sys, "modules", {"sparsebase_tpu_torch": None, "sparsebase_tpu_torch.ops": None,
                                         "jaxtyping": None, "benchmark": None})
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sparsebase_tpu.ops", None)
    monkeypatch.setitem(sys.modules, "jax", None)
    assert harness.forbidden_modules() == ["jax", "sparsebase_tpu.ops"]
    with pytest.raises(harness.ForbiddenModules):
        harness._check_modules()


def test_a_cpu_run_loads_no_jax_and_run_py_refuses_without_a_card():
    code = (
        "import sys, json, time, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark.core import harness\n"
        "line = harness.run('hpcg.dia_solve', 5, 0.1, False, process_start=time.perf_counter(),\n"
        "                   dev=torch.device('cpu'), overrides={'nx': 6, 'ny': 6, 'nz': 6})\n"
        "print(json.dumps({'correct': line['correct'], 'forbidden': harness.forbidden_modules()}))\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == '{"correct": true, "forbidden": []}'
    run = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "kron.preprocess", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, env=env, timeout=300,
                         cwd=ROOT)
    assert run.returncode != 0 and run.stdout == ""
    assert "CUDA card" in run.stderr
