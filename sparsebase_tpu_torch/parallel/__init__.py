"""Mesh-sharded formats and distributed functions (``sparsebase_tpu.parallel``).

A mesh is a list of shard devices; on one card the shards may share it
(``make_mesh(devices=[cuda:0] * 4)``). ``halo`` holds the
boundary-proportional functions, the multilevel ones and SlashBurn;
``ring`` the dense and sparse rings for triangle counts and Jaccard
weights; ``scaling`` the weak-scaling harness.

``multihost`` joins a ``torch.distributed`` group and builds a mesh that
spans its processes (``global_mesh``), each process driving its own
shards. On such a mesh these run, each giving every process the
single-process mesh's result: ``ShardedCSR.from_coo_sharded``,
``with_halo``, ``nnz``, ``nnz_counts``, ``halo_bytes_per_exchange`` and
``to_csr``; every function of ``dist``; ``halo.spmv``,
``step_comm_bytes``, ``bfs_levels``, ``label_prop_partition``,
``connected_components``, ``rcm_reorder``, ``edge_cut`` and
``refine_partition``; and every collective. ``halo``'s multilevel functions
and SlashBurn, ``ring``, ``sharded2d`` and ``ShardedCSR.from_csr``,
``stacked`` and ``to`` raise ``NotImplementedError`` there, naming their
ROADMAP.md item (10g-10i).
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
