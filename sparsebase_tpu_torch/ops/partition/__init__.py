"""Partitioning algorithms (reference: src/sparsebase/partition/).

Every partitioner returns ``part[vertex] = part_id`` as an int32 tensor on
the input's device. As in the JAX package, these are native implementations
(multilevel k-way, size-constrained label propagation, column-net
hypergraph label propagation) where the reference wraps METIS, PULP and
PaToH: the multilevel and hypergraph partitioners run on the host, label
propagation's rounds on the card (kernel K7).
"""

from .base import Partitioner, balance_ratio, edge_cut, part_sizes
from .hypergraph import PatohPartition, PatohPartitionParams, column_net_hypergraph, cutsize_connectivity
from .labelprop import PulpPartition, PulpPartitionParams
from .multilevel import MetisPartition, MetisPartitionParams

__all__ = [
    "Partitioner",
    "edge_cut",
    "part_sizes",
    "balance_ratio",
    "MetisPartition",
    "MetisPartitionParams",
    "PulpPartition",
    "PulpPartitionParams",
    "PatohPartition",
    "PatohPartitionParams",
    "column_net_hypergraph",
    "cutsize_connectivity",
]
