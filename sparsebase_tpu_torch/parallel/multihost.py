"""Multi-process wiring for the distributed tier, on ``torch.distributed``.

Counterpart of ``sparsebase_tpu/parallel/multihost.py``. Once a process
group is up, the mesh of :func:`global_mesh` spans every process's shard
devices, each shard owned by one rank, and the functions that run across
processes (``parallel/__init__.py`` lists them) run unchanged on it: each
process drives its own shards, and ``parallel.collectives`` moves what
crosses a process boundary through the group.

* :func:`initialize` — joins the process group (a coordinator address,
  the process count and the rank, or torch's standard variables
  ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE``); a second
  call does nothing;
* :func:`global_mesh` — the 1-D mesh over every process's shard devices,
  in rank order; :func:`global_mesh_2d` the 2-D one, laid out row-major;
* :func:`local_entry_counts` — this process's slice of a global entry
  list, for a per-process read of the input;
* :func:`launch` — starts a group of local processes under a time limit.

The backend is ``"nccl"`` when every process has a card of its own and
``"gloo"`` otherwise (the CPU, or several processes sharing one card;
NCCL refuses two ranks on one card). Under gloo a CUDA tensor that crosses
a process boundary is staged through host memory.
"""

from __future__ import annotations

import datetime
import math
import os
import socket
import subprocess
import tempfile
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import Mesh, _devices, make_mesh_2d

ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def _group() -> Tuple[int, int]:
    """``(world size, rank)``; ``(1, 0)`` outside a process group."""
    import torch.distributed as tdist

    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size(), tdist.get_rank()
    return 1, 0


def default_backend(num_processes: int) -> str:
    """``"nccl"`` when the processes on this host (``LOCAL_WORLD_SIZE``,
    else ``num_processes``) each have a visible card of their own, else
    ``"gloo"``."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    if torch.cuda.is_available() and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               timeout: Optional[float] = None) -> bool:
    """Join the process group; returns whether more than one process is in
    it. ``coordinator_address`` (``"host:port"``), ``num_processes`` and
    ``process_id`` go together; with none of them the group is taken from
    torch's standard variables (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``, as ``torchrun`` and :func:`launch` set them), and with
    none of those set nothing is joined and the result is False. A second
    call does nothing. ``backend`` defaults to :func:`default_backend`;
    under NCCL the process takes its card (``LOCAL_RANK``, else the rank
    modulo the visible cards) as the current device. A group that was asked
    for and cannot be joined raises; ``timeout`` (seconds) bounds the wait."""
    import torch.distributed as tdist

    if tdist.is_initialized():
        return tdist.get_world_size() > 1
    given = (coordinator_address, num_processes, process_id)
    if all(v is None for v in given):
        if not all(k in os.environ for k in ENV):
            return False
        init, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    elif any(v is None for v in given):
        raise ValueError("initialize: give coordinator_address, num_processes and process_id together, or none")
    else:
        init, world, rank = f"tcp://{coordinator_address}", int(num_processes), int(process_id)
    backend = backend or default_backend(world)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    extra = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    tdist.init_process_group(backend, init_method=init, world_size=world, rank=rank, **extra)
    return world > 1


def global_mesh(axis: str = "x", devices=None) -> Mesh:
    """The 1-D mesh over every process's shard devices, in rank order. Each
    process gives its own list: ``devices`` (e.g. ``["cpu"] * 2``, or a card
    named twice on a shared card), else its visible cards (with no card and
    no ``devices`` it raises, as ``make_mesh`` does). The lists are
    exchanged once. In a single process this is ``make_mesh(devices=...)``."""
    local = _devices(None, devices)
    world, rank = _group()
    if world == 1:
        return Mesh(local, (axis,))
    devs, owners = _every_process(local, "global_mesh")
    return Mesh(devs, (axis,), owners=owners, rank=rank)


def global_mesh_2d(shape: Sequence[int], axes: Sequence[str] = ("x", "y"), devices=None) -> Mesh:
    """The 2-D mesh of ``shape`` over every process's shard devices, in
    rank order laid out row-major, each owned by the process that gave it
    (the counterpart of the JAX ``make_mesh_2d`` over every process's
    ``jax.devices()``). Each process gives its own list, as to
    :func:`global_mesh`; raises where the lists do not fill ``shape``. In a
    single process this is ``make_mesh_2d(shape, axes, devices=...)``."""
    shape = tuple(int(s) for s in shape)
    world, rank = _group()
    if world == 1:
        return make_mesh_2d(shape, axes, devices=devices)
    devs, owners = _every_process(_devices(None, devices), "global_mesh_2d")
    if len(devs) != math.prod(shape):
        raise ValueError(f"global_mesh_2d: {len(devs)} devices over the processes do not fill a mesh of {shape}")
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(shape), tuple(axes), owners=np.asarray(owners).reshape(shape), rank=rank)


def _every_process(local: list, where: str) -> Tuple[list, list]:
    """Every process's device names in rank order and each one's owner
    rank: the lists are exchanged once."""
    import torch.distributed as tdist

    lists = [None] * tdist.get_world_size()
    tdist.all_gather_object(lists, [str(d) for d in local])
    devs, owners = [], []
    for r, names in enumerate(lists):
        if not names:
            raise ValueError(f"{where}: rank {r} gave no devices")
        devs += names
        owners += [r] * len(names)
    return devs, owners


def local_entry_counts(total_nnz: int) -> Tuple[int, int]:
    """``(start, count)`` of this process's slice of a global entry list:
    equal slices of ``ceil(total / processes)`` entries in rank order, the
    last ones shorter or empty."""
    p, i = _group()
    per = -(-total_nnz // p)
    start = min(i * per, total_nnz)
    return start, min(per, total_nnz - start)


def free_port() -> int:
    """A TCP port of this host that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(argv: Sequence[str], nprocs: int, timeout: float, cwd: Optional[str] = None) -> List[subprocess.CompletedProcess]:
    """Run ``nprocs`` processes of ``argv`` as one group on this host: each
    gets torch's standard variables (``MASTER_ADDR`` localhost, a free
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``), so that :func:`initialize` with no arguments joins
    the group. Waits at most ``timeout`` seconds in all. When a process
    fails or the time runs out, every process still running is killed and
    ``RuntimeError`` names each one's exit code and the tail of its
    standard error. Returns each process's result, stdout and stderr as
    text."""
    base = dict(os.environ)
    base.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()), WORLD_SIZE=str(nprocs),
                LOCAL_WORLD_SIZE=str(nprocs))
    procs, files = [], []
    try:
        for r in range(nprocs):
            out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
            files.append((out, err))
            procs.append(subprocess.Popen(list(argv), stdout=out, stderr=err, cwd=cwd,
                                          env={**base, "RANK": str(r), "LOCAL_RANK": str(r)}))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    results = []
    for r, (p, (out, err)) in enumerate(zip(procs, files)):
        out.seek(0)
        err.seek(0)
        results.append(subprocess.CompletedProcess(p.args, p.returncode, out.read().decode(errors="replace"),
                                                   err.read().decode(errors="replace")))
        out.close()
        err.close()
    if any(r.returncode != 0 for r in results):
        timed_out = time.monotonic() > deadline
        raise RuntimeError(f"launch: {'time limit of %g s reached; ' % timeout if timed_out else ''}" + "; ".join(
            f"rank {k} exited {r.returncode}:\n{r.stderr[-3000:]}" for k, r in enumerate(results)))
    return results
