"""Mesh-sharded formats and distributed functions (``sparsebase_tpu.parallel``).

A mesh is a list of shard devices; on one card the shards may share it
(``make_mesh(devices=[cuda:0] * 4)``). ``halo`` holds the
boundary-proportional functions, the multilevel ones and SlashBurn;
``ring`` the dense and sparse rings for triangle counts and Jaccard
weights; ``scaling`` the weak-scaling harness.

``multihost`` joins a ``torch.distributed`` group and builds a mesh that
spans its processes (``global_mesh``, and ``global_mesh_2d`` for
``sharded2d``), each process driving its own shards. Every function of the
tier runs on such a mesh and gives every process the single-process mesh's
result bit for bit: the containers' constructors, reads and moves
(``ShardedCSR``: ``from_coo_sharded``, ``from_coo_blocks``, ``from_csr``,
``from_csr_balanced``, ``with_halo``, ``stacked``, ``to``, ``to_csr``;
``Sharded2DCSR``: ``from_csr``, ``stacked``), every function of ``dist``,
``halo``, ``ring`` and ``sharded2d``, and every collective. Each process makes the
same calls in the same order and passes ``None`` in a remote shard's slot.
"""

from . import collectives, halo, multihost, ring, scaling, sharded2d
from .dist import (
    bfs_levels,
    degree_reorder,
    degrees,
    edge_cut,
    label_prop_partition,
    rcm_reorder,
    refine_partition,
    reorder_heatmap,
    spmv,
    structure_features,
)
from .mesh import Mesh, Placement, make_mesh, make_mesh_2d, replicated, shard_rows
from .sharded import ShardedCSR, balanced_row_order
from .sharded2d import Sharded2DCSR

# joining the conversion graph: CSR <-> ShardedCSR placement edges
from ..convert.graph import _register_mesh_edges

_register_mesh_edges()

__all__ = [
    "Mesh",
    "Placement",
    "ShardedCSR",
    "Sharded2DCSR",
    "balanced_row_order",
    "collectives",
    "halo",
    "multihost",
    "ring",
    "scaling",
    "sharded2d",
    "make_mesh",
    "make_mesh_2d",
    "shard_rows",
    "replicated",
    "spmv",
    "degrees",
    "bfs_levels",
    "degree_reorder",
    "rcm_reorder",
    "label_prop_partition",
    "refine_partition",
    "edge_cut",
    "structure_features",
    "reorder_heatmap",
]
