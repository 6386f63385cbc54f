"""``parallel.multihost`` on the CPU: the single-process case (JAX
``tests/test_parallel.py::TestMultihost``), ``global_mesh_2d`` in one
process and in a group of two, ``local_entry_counts`` against
the JAX function for each rank of several group sizes, joining a group
from explicit arguments, and ``launch``'s time limit and failures."""

import subprocess
import sys

import pytest
import torch

from sparsebase_tpu_torch.parallel import make_mesh, make_mesh_2d, multihost

LAUNCH_TIME_LIMIT = 60  # seconds for each launched group; each takes a few


def test_single_process(monkeypatch):
    for name in multihost.ENV:
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize() is False
    assert not torch.distributed.is_initialized()
    mesh = multihost.global_mesh(devices=["cpu"] * 4)
    assert mesh.size == 4 and mesh == make_mesh(devices=["cpu"] * 4) and not mesh.spans_processes
    assert multihost.local_entry_counts(1000) == (0, 1000)


@pytest.mark.parametrize("shape,axes", [((2, 2), ("x", "y")), ((1, 4), ("x", "y")), ((4, 2), ("y", "x"))])
def test_global_mesh_2d_in_one_process_is_make_mesh_2d(monkeypatch, shape, axes):
    for name in multihost.ENV:
        monkeypatch.delenv(name, raising=False)
    devices = ["cpu"] * (shape[0] * shape[1])
    mesh = multihost.global_mesh_2d(shape, axes, devices=devices)
    assert mesh == make_mesh_2d(shape, axes, devices=devices) and not mesh.spans_processes
    assert mesh.shape == dict(zip(axes, shape))


def test_global_mesh_2d_in_one_process_raises_where_the_devices_do_not_fill_it(monkeypatch):
    for name in multihost.ENV:
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="takes 6 devices, 4 were given"):
        multihost.global_mesh_2d((2, 3), devices=["cpu"] * 4)


MESH_2D = """
import torch.distributed as tdist
from sparsebase_tpu_torch.parallel import multihost
assert multihost.initialize(backend="gloo", timeout=30)
mesh = multihost.global_mesh_2d((2, 2), devices=["cpu"] * 2)
print(mesh.owners.tolist(), mesh.rank, mesh.local, mesh.axis_names, mesh.spans_processes)
try:
    multihost.global_mesh_2d((3, 2), devices=["cpu"] * 2)
except ValueError as e:
    print("refused:", e)
tdist.destroy_process_group()
"""


def test_global_mesh_2d_lays_the_processes_out_row_major():
    out = multihost.launch([sys.executable, "-c", MESH_2D], 2, timeout=LAUNCH_TIME_LIMIT)
    for rank, r in enumerate(out):
        lines = r.stdout.splitlines()
        assert lines[0] == f"[[0, 0], [1, 1]] {rank} {(2 * rank, 2 * rank + 1)} ('x', 'y') True"
        assert lines[1] == "refused: global_mesh_2d: 4 devices over the processes do not fill a mesh of (3, 2)"


def test_global_mesh_needs_a_card_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        multihost.global_mesh()


def test_initialize_takes_all_three_arguments():
    with pytest.raises(ValueError, match="together"):
        multihost.initialize(coordinator_address="localhost:1", num_processes=2)


@pytest.mark.parametrize("total", [0, 1, 7, 1000])
@pytest.mark.parametrize("world", [1, 2, 3, 8])
def test_local_entry_counts_equals_jax(monkeypatch, world, total):
    jax = pytest.importorskip("jax")
    from sparsebase_tpu.parallel import multihost as ref

    import torch.distributed as tdist

    got, want = [], []
    for rank in range(world):
        monkeypatch.setattr(jax, "process_count", lambda: world)
        monkeypatch.setattr(jax, "process_index", lambda: rank)
        monkeypatch.setattr(tdist, "is_initialized", lambda: True)
        monkeypatch.setattr(tdist, "get_world_size", lambda: world)
        monkeypatch.setattr(tdist, "get_rank", lambda: rank)
        got.append(multihost.local_entry_counts(total))
        want.append(ref.local_entry_counts(total))
    assert got == want
    assert sum(c for _, c in got) == total


JOIN = """
import sys
from sparsebase_tpu_torch.parallel import multihost
import torch.distributed as tdist
port = multihost.free_port()
try:
    multihost.initialize(f"localhost:{port}", 1, 0, backend="no-such-backend", timeout=20)
except Exception as e:
    print("refused:", type(e).__name__)
assert not tdist.is_initialized()
print(multihost.initialize(f"localhost:{multihost.free_port()}", 1, 0, backend="gloo", timeout=20),
      tdist.get_backend(), tdist.get_world_size(), multihost.initialize(), multihost.local_entry_counts(9))
print(multihost.global_mesh(devices=["cpu"] * 2))
"""


def test_initialize_joins_a_group_and_raises_on_failure():
    r = subprocess.run([sys.executable, "-c", JOIN], capture_output=True, text=True, timeout=LAUNCH_TIME_LIMIT)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert lines[0].startswith("refused: ")
    assert lines[1] == "False gloo 1 False (0, 9)"
    assert lines[2].startswith("Mesh({'x': 2}")


def test_launch_gives_each_rank_the_group_variables():
    code = "import os; print(*(os.environ[k] for k in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'LOCAL_RANK')))"
    out = multihost.launch([sys.executable, "-c", code], 3, timeout=LAUNCH_TIME_LIMIT)
    assert [r.stdout.split() for r in out] == [[str(k), "3", "localhost", str(k)] for k in range(3)]


def test_launch_kills_the_group_at_its_time_limit():
    with pytest.raises(RuntimeError, match="time limit of 2 s"):
        multihost.launch([sys.executable, "-c", "import time; time.sleep(600)"], 2, timeout=2)


def test_launch_raises_with_a_failed_rank_stderr():
    code = "import os, sys, time\nif os.environ['RANK'] == '1': sys.exit('rank one fails')\ntime.sleep(600)"
    with pytest.raises(RuntimeError, match="rank one fails"):
        multihost.launch([sys.executable, "-c", code], 2, timeout=LAUNCH_TIME_LIMIT)
