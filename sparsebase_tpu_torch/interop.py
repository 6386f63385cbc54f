"""Carry formats and objects across from the JAX reference package, and back
to numpy.

A reference format is recognised by its class name (``COO``, ``CSR``,
``CSC``, ``DIA``, ``ELL``, ``DenseArray``, ``PaddedCSR``): a CSC has the same
field names as a CSR and is its transpose. So are the objects that hold
formats (``Graph``, ``HyperGraph``) and the SBFF container
(``SbffObject``), and the sharded containers (``ShardedCSR``,
``Sharded2DCSR``), given a port mesh. Its fields are read by name and
every array is taken through ``np.asarray``, so this module never imports
``jax`` or ``sparsebase_tpu``. Ids become int32 (checked), offsets int64;
values keep their dtype, bf16 included.
"""

from __future__ import annotations

import numpy as np
import torch

from .formats.array import DenseArray
from .formats.coo import COO
from .formats.csc import CSC
from .formats.csr import CSR
from .formats.dia import DIA
from .formats.ell import ELL
from .formats.padded import PaddedCSR
from .io.binary import SbffObject
from .objects import Graph, HyperGraph
from .utils.exceptions import TypeMismatchError
from .utils.typing import convert_array_dtype


def _tensor(a) -> torch.Tensor:
    """A CPU tensor holding a copy of the array's data."""
    arr = np.array(np.asarray(a), order="C")  # a copy, 0-d kept
    if arr.dtype.name == "bfloat16":  # numpy has no native bf16: move the bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _ids(a, device) -> torch.Tensor:
    return convert_array_dtype(_tensor(a), torch.int32).to(device)


def _vals(a, device):
    return None if a is None else _tensor(a).to(device)


def _offsets(a, device) -> torch.Tensor:
    return _tensor(a).to(device=device, dtype=torch.int64)


# the sharded containers' fields, each split on its leading (shard) axes
_SHARDED_FIELDS = {"indptr": _offsets, "indices": _ids, "vals": _vals, "nnz_local": _offsets,
                   "halo_send": _ids, "halo_counts": _offsets, "halo_map": _ids}


def _sharded_from_reference(fmt, mesh):
    """A reference ShardedCSR or Sharded2DCSR on the port mesh ``mesh``: row
    k (tile (i, j)) of each array on the mesh's device k ((i, j))."""
    from .parallel import Sharded2DCSR, ShardedCSR

    shape = tuple(int(s) for s in fmt._shape)
    if type(fmt).__name__ == "ShardedCSR":
        devices = mesh.axis_devices(fmt._axis)
        fields = dict.fromkeys(_SHARDED_FIELDS)
        for name, conv in _SHARDED_FIELDS.items():
            a = getattr(fmt, name, None)
            if a is not None:
                arr = np.asarray(a)
                if arr.shape[0] != len(devices):
                    raise TypeMismatchError(f"{name} has {arr.shape[0]} shards; the mesh has {len(devices)}")
                fields[name] = tuple(conv(arr[k], dev) for k, dev in enumerate(devices))
        return ShardedCSR(_shape=shape, _axis=fmt._axis, **fields)
    devices = mesh.devices if mesh.axis_names.index(fmt._axes[0]) == 0 else mesh.devices.T
    fields = dict.fromkeys(("indptr", "indices", "vals", "nnz_local"))
    for name in fields:
        a = getattr(fmt, name)
        if a is not None:
            arr = np.asarray(a)
            if arr.shape[:2] != devices.shape:
                raise TypeMismatchError(f"{name} has a grid of {arr.shape[:2]}; the mesh has {devices.shape}")
            fields[name] = tuple(tuple(_SHARDED_FIELDS[name](arr[i, j], devices[i, j]) for j in range(arr.shape[1]))
                                 for i in range(arr.shape[0]))
    return Sharded2DCSR(_shape=shape, _axes=tuple(fmt._axes), _mesh=mesh, **fields)


def from_reference(fmt, device):
    """The port's counterpart of a reference COO, CSR, CSC, DIA, ELL,
    DenseArray or PaddedCSR, on ``device``; of a Graph or HyperGraph, its
    formats on ``device``; of an SbffObject, its arrays as CPU tensors; of a
    ShardedCSR or Sharded2DCSR, its shards on the port mesh ``device``."""
    kind = type(fmt).__name__
    if kind in ("ShardedCSR", "Sharded2DCSR"):
        return _sharded_from_reference(fmt, device)
    if kind == "SbffObject":
        obj = SbffObject(fmt.name)
        obj.add_dimensions(fmt.dimensions)
        for name, arr in fmt._arrays.items():
            obj.add_array(name, _tensor(arr))
        return obj
    if kind == "HyperGraph":
        return HyperGraph(
            from_reference(fmt.connectivity, device), from_reference(fmt.xnet_csr, device),
            net_weights=None if fmt.net_weights is None else from_reference(fmt.net_weights, device),
            cell_weights=None if fmt.cell_weights is None else from_reference(fmt.cell_weights, device),
            base_type=fmt.base_type, constraint_num=fmt.constraint_num,
        )
    if kind == "Graph":
        conn = None if fmt.connectivity is None else from_reference(fmt.connectivity, device)
        weights = None if fmt.vertex_weights is None else [from_reference(w, device) for w in fmt.vertex_weights]
        return Graph(conn, ncon=fmt.ncon, vertex_weights=weights)
    if kind == "DenseArray":
        return DenseArray(_vals(fmt.vals, device))
    if kind == "PaddedCSR":
        shape = tuple(int(s) for s in fmt._orig_shape)
        return PaddedCSR(from_reference(fmt.csr, device), shape, int(fmt._orig_nnz))
    if kind not in ("COO", "CSR", "CSC", "DIA", "ELL"):
        raise TypeMismatchError(f"no port counterpart for {kind}")
    shape = tuple(int(s) for s in fmt._shape)
    if kind == "COO":
        return COO(_ids(fmt.row, device), _ids(fmt.col, device), _vals(fmt.vals, device), shape)
    if kind in ("CSR", "CSC"):
        cls = CSR if kind == "CSR" else CSC
        return cls(_offsets(fmt.indptr, device), _ids(fmt.indices, device), _vals(fmt.vals, device), shape)
    if kind == "DIA":
        return DIA(_ids(fmt.offsets, device), _vals(fmt.data, device), shape)
    return ELL(_ids(fmt.cols, device), _vals(fmt.vals, device), _ids(fmt.lens, device), shape)


def _numpy(t):
    if t is None:
        return None
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def to_numpy(fmt) -> dict:
    """The format's arrays as numpy (bf16 widened to f32), keyed by field
    name, plus ``shape``; a PaddedCSR gives its padded CSR's arrays, and
    ``nnz`` (the true count) beside its true ``shape``. A Graph gives its
    connectivity's, ``n``, ``m``, ``ncon`` and its vertex weights; a
    HyperGraph also ``xnet``, its net and cell weights, ``base_type`` and
    ``constraint_num``; an SbffObject its ``name``, ``dimensions`` and
    ``arrays``. A ShardedCSR or Sharded2DCSR gives each field as the JAX
    container's stacked array, plus ``shape``."""
    from .parallel import Sharded2DCSR, ShardedCSR

    if isinstance(fmt, (ShardedCSR, Sharded2DCSR)):
        return {"shape": fmt.shape, **{name: _numpy(fmt.stacked(name)) for name in fmt._FIELDS}}
    if isinstance(fmt, SbffObject):
        return {"name": fmt.name, "dimensions": list(fmt.dimensions),
                "arrays": {k: _numpy(fmt.get_array(k)) for k in fmt._arrays}}
    if isinstance(fmt, Graph):
        out = {"connectivity": None if fmt.connectivity is None else to_numpy(fmt.connectivity), "n": fmt.n,
               "m": fmt.m, "ncon": fmt.ncon,
               "vertex_weights": None if fmt.vertex_weights is None else [_numpy(w.vals) for w in fmt.vertex_weights]}
        if isinstance(fmt, HyperGraph):
            out.update(xnet=to_numpy(fmt.xnet_csr), base_type=fmt.base_type, constraint_num=fmt.constraint_num,
                       net_weights=None if fmt.net_weights is None else _numpy(fmt.net_weights.vals),
                       cell_weights=None if fmt.cell_weights is None else _numpy(fmt.cell_weights.vals))
        return out
    if isinstance(fmt, PaddedCSR):
        return {**to_numpy(fmt.csr), "shape": fmt.shape, "nnz": fmt.nnz}
    out = {"shape": fmt.shape}
    for name in ("row", "col", "indptr", "indices", "cols", "lens", "offsets", "data", "vals"):
        if hasattr(fmt, name):
            out[name] = _numpy(getattr(fmt, name))
    return out
