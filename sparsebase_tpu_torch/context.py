"""Execution place: where a format's tensors live.

Counterpart of ``sparsebase_tpu/context.py`` (reference:
src/sparsebase/context/context.h:18-21, cpu_context.h:12,
cuda_context_cuda.cuh:14-19). The place is read from ``tensor.device``:

* ``HostContext``            — tensors on the CPU
* ``DeviceContext(device)``  — tensors on one CUDA device
* ``MeshContext(mesh, axis)`` — per-shard tensors, one list of shards over
                               the devices of ``mesh`` along ``axis``

Equivalence follows the reference's ``IsEquivalent``: two contexts are
equivalent iff data placed in one can be consumed in the other without a
transfer.
"""

from __future__ import annotations

import dataclasses

import torch


class Context:
    """Base execution place; each subclass names its ``device``."""

    def is_equivalent(self, other: "Context") -> bool:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class HostContext(Context):
    """Tensors live in host memory."""

    def is_equivalent(self, other: Context) -> bool:
        return isinstance(other, HostContext)

    @property
    def device(self) -> torch.device:
        return torch.device("cpu")

    def __repr__(self) -> str:
        return "HostContext()"


@dataclasses.dataclass(frozen=True)
class DeviceContext(Context):
    """Tensors live on one CUDA device, named explicitly
    (``torch.device("cuda", i)``)."""

    device: torch.device

    def __post_init__(self):
        if torch.device(self.device).type == "cpu":
            raise ValueError("DeviceContext needs an accelerator device; use HostContext")
        object.__setattr__(self, "device", torch.device(self.device))

    def is_equivalent(self, other: Context) -> bool:
        return isinstance(other, DeviceContext) and self.device == other.device

    def __repr__(self) -> str:
        return f"DeviceContext({self.device})"


@dataclasses.dataclass(frozen=True)
class MeshContext(Context):
    """Tensors are split into shards over a device mesh
    (``parallel.mesh.Mesh``), one shard per device along ``axis``.

    The JAX counterpart holds arrays sharded by XLA; here a sharded format
    holds one tensor per shard on that shard's device, all driven from one
    process. A mesh may name one device several times (``make_mesh(devices=
    [cuda:0] * 4)``): its shards then share that device."""

    mesh: object
    axis: str = "x"

    def is_equivalent(self, other: Context) -> bool:
        return isinstance(other, MeshContext) and self.mesh == other.mesh and self.axis == other.axis

    @property
    def devices(self) -> tuple:
        """The shard devices along ``axis`` (the first along every other axis)."""
        return self.mesh.axis_devices(self.axis)

    def __repr__(self) -> str:
        return f"MeshContext(axes={self.mesh.shape}, axis={self.axis!r})"


CPU_CONTEXT = HostContext()


def context_for(device) -> Context:
    """The context of tensors placed on ``device``."""
    device = torch.device(device)
    return HostContext() if device.type == "cpu" else DeviceContext(device)


def context_of(x) -> Context:
    """The context of a tensor (``None`` counts as host) or of a format
    (a sharded format gives its ``MeshContext``)."""
    if x is None:
        return HostContext()
    if hasattr(x, "device"):
        return context_for(x.device)
    return x.context
