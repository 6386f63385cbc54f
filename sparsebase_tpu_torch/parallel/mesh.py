"""Device meshes and placements.

Counterpart of ``sparsebase_tpu/parallel/mesh.py``. The JAX mesh is a
``jax.sharding.Mesh`` whose collectives XLA inserts; here a mesh is an array
of ``torch.device`` with axis names, driven from one process (as ``shard_map``
is on one host): a sharded format holds one tensor per shard on that
shard's device, and ``parallel.collectives`` combines them.

A mesh is built from the visible CUDA cards, or from an explicit device
list, which may name one device several times: ``make_mesh(devices=
[torch.device("cuda", 0)] * 4)`` puts four shards on one card, and
``make_mesh(devices=["cpu"] * 8)`` eight on the CPU (the counterpart of
JAX's virtual CPU devices). Nothing falls back to the CPU on its own.

A mesh may span processes (``multihost.global_mesh``): each shard has an
owner, the rank of the process that drives it, and a mesh is seen from one
process (``rank``), which holds tensors only for its own shards
(``local``); a sharded field then has ``None`` in a remote shard's slot.
Two processes' ``cuda:0`` are two shards. A single-process mesh has rank 0
everywhere. Every function of the tier runs on such a mesh, each process
driving its own shards (``parallel/__init__.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch


class Mesh:
    """An array of devices with one name per axis; ``shape[axis]`` is the
    number of shards along ``axis``."""

    def __init__(self, devices, axis_names: Sequence[str], owners=None, rank: int = 0):
        given = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if given.ndim != len(self.axis_names):
            raise ValueError(f"a mesh of {given.ndim} dims needs as many axis names, got {self.axis_names}")
        arr = np.empty(given.size, dtype=object)
        arr[:] = [torch.device(d) for d in given.reshape(-1)]
        self.devices = arr.reshape(given.shape)
        self.owners = np.zeros(given.shape, dtype=np.int64) if owners is None else \
            np.asarray(owners, dtype=np.int64).reshape(given.shape)
        self.rank = int(rank)
        if not (self.owners == self.rank).any():
            raise ValueError(f"rank {self.rank} drives no shard of the mesh (owners {self.owners.tolist()})")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def spans_processes(self) -> bool:
        return bool((self.owners != self.rank).any())

    @property
    def local(self) -> tuple:
        """The flat indices of the shards this process drives."""
        return tuple(int(k) for k in np.flatnonzero(self.owners.reshape(-1) == self.rank))

    @property
    def first_device(self) -> torch.device:
        """This process's first shard's device, where replicated results land."""
        return self.devices.reshape(-1)[self.local[0]]

    def axis_devices(self, axis: str) -> tuple:
        """The devices along ``axis``, at index 0 of every other axis."""
        return tuple(_along(self.devices, self.axis_names.index(axis)))

    def axis_owners(self, axis: str) -> tuple:
        """The owner ranks of the shards along ``axis``, as :meth:`axis_devices`."""
        return tuple(int(o) for o in _along(self.owners, self.axis_names.index(axis)))

    def _key(self):
        return (self.axis_names, self.devices.shape, tuple(self.devices.reshape(-1)), tuple(self.owners.reshape(-1)))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        owners = f", owners={self.owners.reshape(-1).tolist()}, rank={self.rank}" if self.spans_processes else ""
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.reshape(-1)]}{owners})"


def _along(arr: np.ndarray, k: int) -> np.ndarray:
    """The entries of ``arr`` along its axis ``k``, at index 0 of every other axis."""
    return np.moveaxis(arr, k, 0).reshape(arr.shape[k], -1)[:, 0]


def _devices(count: int, devices) -> list:
    """``devices`` as a list of ``count`` torch devices, or the first
    ``count`` visible CUDA cards (raises when there are fewer)."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if count is not None and len(devices) != count:
            raise ValueError(f"the mesh takes {count} devices, {len(devices)} were given")
        return devices
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA card is visible; pass devices= (e.g. ['cpu'] * 4) for a mesh elsewhere")
    visible = torch.cuda.device_count()
    count = visible if count is None else count
    if count > visible:
        raise RuntimeError(f"make_mesh: {count} devices asked for, {visible} CUDA cards visible; pass devices= to "
                           "place several shards on one card")
    return [torch.device("cuda", i) for i in range(count)]


def make_mesh(n_devices: Optional[int] = None, axis: str = "x", devices=None) -> Mesh:
    """1-D mesh over ``devices``, else over the first ``n_devices`` CUDA
    cards (default: all). Unlike JAX, asking for more cards than are
    visible raises instead of giving a smaller mesh."""
    return Mesh(_devices(n_devices, devices), (axis,))


def make_mesh_2d(shape: Sequence[int], axes: Sequence[str] = ("x", "y"), devices=None) -> Mesh:
    """2-D mesh of ``shape`` over ``devices`` (row-major), else over the
    first ``prod(shape)`` CUDA cards; the same rules as :func:`make_mesh`."""
    shape = tuple(int(s) for s in shape)
    devs = np.empty(math.prod(shape), dtype=object)
    devs[:] = _devices(math.prod(shape), devices)
    return Mesh(devs.reshape(shape), tuple(axes))


class Placement:
    """Where a sharded format's tensors go on a mesh: along ``axis`` (one
    piece per shard), or on every device of the mesh (``axis=None``)."""

    def __init__(self, mesh: Mesh, axis: Optional[str]):
        self.mesh = mesh
        self.axis = axis

    @property
    def devices(self) -> tuple:
        if self.axis is None:
            return tuple(self.mesh.devices.reshape(-1))
        return self.mesh.axis_devices(self.axis)

    @property
    def owners(self) -> tuple:
        if self.axis is None:
            return tuple(int(o) for o in self.mesh.owners.reshape(-1))
        return self.mesh.axis_owners(self.axis)

    def put(self, t) -> tuple:
        """One tensor per device of the placement. Along an axis, ``t`` is a
        sequence of pieces (piece k goes to device k) or a tensor whose
        leading dimension splits evenly into them; replicated, ``t`` is one
        tensor, copied to each device (no copy where it already lies there).
        A shard of another process gets ``None``."""
        devices, rank = self.devices, self.mesh.rank
        devices = [d if o == rank else None for d, o in zip(devices, self.owners)]
        if self.axis is None:
            return tuple(None if d is None else t.to(d) for d in devices)
        if isinstance(t, torch.Tensor):
            if t.shape[0] % len(devices):
                raise ValueError(f"a leading dimension of {t.shape[0]} does not split into {len(devices)} shards")
            t = t.tensor_split(len(devices))
        pieces = tuple(t)
        if len(pieces) != len(devices):
            raise ValueError(f"{len(pieces)} pieces for {len(devices)} shards")
        return tuple(None if d is None else p.to(d) for p, d in zip(pieces, devices))

    def __repr__(self) -> str:
        return f"Placement({self.mesh!r}, axis={self.axis!r})"


def shard_rows(mesh: Mesh, axis: str = "x") -> Placement:
    """Shard the leading dimension over ``axis``."""
    return Placement(mesh, axis)


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, None)
