"""Size-constrained label-propagation partitioning (PULP-equivalent).

Counterpart of ``sparsebase_tpu/ops/partition/labelprop.py`` (reference
``partition::PulpPartition``, src/sparsebase/partition/
pulp_partition.cc:30-69, which wraps the PULP solver; params
pulp_partition.h):

1. initial labels: a multi-source BFS from ``k`` random seeds
   (``do_bfs_init``), else contiguous chunks;
2. propagation: each round every vertex scores every part by its
   (optionally weighted) neighbour count less an over-capacity penalty that
   grows round by round, and all vertices move at once to their best part:
   kernel K7 on a CUDA CSR (``ops/kernels/label_prop.py``), its plain
   version on a CPU one;
3. balance fix-up and a final boundary refinement, on the host.

Unweighted, with graphkit built and ``config.use_graphkit`` on, the whole
partitioner is graphkit's ``pulp`` on a host copy, with the seeds drawn as
the JAX package draws them. The labels come back as int32 on the input's
device.

The JAX package's two routes differ in one respect: its numpy route stops
at the first round that changes nothing, its jnp route runs every round.
Since the penalty grows with the round, a labelling stable in one round may
move in a later one, so the two can differ. :func:`_propagate` takes the
choice as ``stop_when_stable``. ``PulpPartition`` stops (the numpy route's
labels, on every device: one host read a round on the card, where the
partitioner goes to the host anyway); ``models.partition_pipeline`` runs
every round with no host read (the jnp route's labels).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...formats.csr import CSR
from ..kernels.label_prop import label_prop_round
from ..kernels.label_prop import neighbor_counts as _neighbor_counts  # the (n, k) float32 counts
from .base import Partitioner
from .multilevel import _host_weights, _refine, _symmetrize

_UNREACHED = 2**30  # the BFS's sentinel: larger than any label


@dataclasses.dataclass
class PulpPartitionParams:
    """The fields of PulpPartitionParams (pulp_partition.h)."""

    num_partitions: int = 2
    vert_balance: float = 1.1
    edge_balance: float = 1.5
    do_lp_init: bool = False
    do_bfs_init: bool = True
    do_repart: bool = False
    do_edge_balance: bool = False
    do_maxcut_balance: bool = False
    seed: int = 42
    num_iterations: int = 20


def _chunks(n: int, k: int, device) -> torch.Tensor:
    """``(v * k) // n`` for each vertex ``v``: ``k`` contiguous chunks, int32."""
    return ((torch.arange(n, dtype=torch.int64, device=device) * k) // max(n, 1)).to(torch.int32)


def _bfs_seed(csr: CSR, k: int, seed: int) -> torch.Tensor:
    """Labels from a multi-source BFS out of ``k`` random seeds (part ``i``
    from seed ``i``), at most 64 rounds of a scatter-min over the entries,
    ending at the first round that changes nothing; vertices never reached
    take their contiguous chunk. A round that changes nothing changes
    nothing later, so both JAX routes give these labels."""
    n = csr.nrows
    dev = csr.indptr.device
    seeds = np.random.default_rng(seed).choice(n, size=min(k, n), replace=False)
    labels = torch.full((n,), -1, dtype=torch.int32, device=dev)
    labels[torch.as_tensor(seeds, device=dev)] = torch.arange(len(seeds), dtype=torch.int32, device=dev)
    row = csr.row_of_nnz().long()
    ids = csr.indices.long()
    for _ in range(64):
        src = labels[row]
        cand = torch.where(src >= 0, src, _UNREACHED)
        prop = torch.full((n,), _UNREACHED, dtype=torch.int32, device=dev).scatter_reduce_(0, ids, cand, "amin")
        new = torch.where((labels < 0) & (prop < _UNREACHED), prop, labels)
        if torch.equal(new, labels):
            break
        labels = new
    return torch.where(labels < 0, _chunks(n, k, dev), labels)


def _propagate(csr: CSR, labels: torch.Tensor, k: int, cap: float, weights: Optional[torch.Tensor],
               num_iterations: int, stop_when_stable: bool) -> torch.Tensor:
    """``num_iterations`` rounds of label propagation, each one K7 call on a
    CUDA CSR (its plain version on a CPU one); the penalty's weight grows
    from ``1 / num_iterations`` to 1. With ``stop_when_stable`` the rounds
    end at the first that changes nothing (one host read a round on the
    card), else every round runs with no host read."""
    labels = labels.to(torch.int32)
    for it in range(num_iterations):
        new = label_prop_round(csr, labels, k, (it + 1) / num_iterations, cap, weights)
        if stop_when_stable and torch.equal(new, labels):
            break
        labels = new
    return labels


def _balance_fixup(csr: CSR, labels, k: int, cap: float) -> np.ndarray:
    """Evict the vertices of least gain from parts over ``floor(cap)`` into
    the best part under it, on the host (a greedy loop over the parts, the
    JAX package's order of moves); int32 labels."""
    labels = np.asarray(torch.as_tensor(labels).cpu()).copy()
    sizes = np.bincount(labels, minlength=k)[:k].astype(np.int64)
    cap_i = int(np.floor(cap))
    if (sizes <= cap_i).all():
        return labels.astype(np.int32)
    counts = _neighbor_counts(csr.to_host(), torch.from_numpy(labels), k).numpy()
    for p in np.argsort(-sizes):
        excess = int(sizes[p]) - cap_i
        if excess <= 0:
            continue
        members = np.nonzero(labels == p)[0]
        # gain of leaving p = the best other part's affinity less p's
        other = counts[members].copy()
        other[:, p] = -np.inf
        best_alt = np.argmax(other, axis=1)
        gain = other[np.arange(len(members)), best_alt] - counts[members, p]
        move_order = np.argsort(-gain)
        moved = 0
        for idx in move_order:
            if moved >= excess:
                break
            tgt = int(best_alt[idx])
            if sizes[tgt] >= cap_i:
                # the next best part under the cap
                order = np.argsort(-other[idx])
                tgt = -1
                for cand in order:
                    if sizes[cand] < cap_i and cand != p:
                        tgt = int(cand)
                        break
                if tgt < 0:
                    continue
            v = int(members[idx])
            labels[v] = tgt
            sizes[p] -= 1
            sizes[tgt] += 1
            moved += 1
    return labels.astype(np.int32)


def label_prop_partition(csr: CSR, params: PulpPartitionParams) -> torch.Tensor:
    """Labels of ``csr``'s vertices, int32 on its device."""
    from ...native import available, pulp
    from ..reorder._host import host_arrays, to_order

    n = csr.nrows
    k = int(params.num_partitions)
    if k <= 1:
        return torch.zeros((n,), dtype=torch.int32, device=csr.indptr.device)
    cap = params.vert_balance * n / k
    weighted = params.do_edge_balance and csr.vals is not None
    if not weighted and available():
        indptr, indices = host_arrays(csr)
        if params.do_bfs_init:
            seeds = np.random.default_rng(params.seed).choice(n, size=min(k, n), replace=False)
        else:
            seeds = np.zeros(0, np.int64)
        return to_order(pulp(n, indptr, indices, seeds, k, cap, params.num_iterations), csr)

    if params.do_bfs_init:
        labels = _bfs_seed(csr, k, params.seed)
    else:
        labels = _chunks(n, k, csr.indptr.device)
    weights = csr.vals if weighted else None
    labels = _propagate(csr, labels, k, cap, weights, params.num_iterations, stop_when_stable=True)
    labels = _balance_fixup(csr, labels, k, cap)
    # the final boundary refinement (PULP's FM-flavoured pass): the multilevel
    # refiner on the symmetrized graph, four rounds
    indptr, indices = host_arrays(csr)
    ew = _host_weights(csr) if weighted else np.ones(csr.nnz, np.float64)
    sip, six, sew = _symmetrize(indptr, indices, ew, n)
    labels = _refine(sip, six, sew, np.ones(n, np.float64), labels.astype(np.int64), k, cap, rounds=4)
    return to_order(labels, csr)


class PulpPartition(Partitioner):
    """Label-propagation k-way partitioner (the PULP API)."""

    def __init__(self, **kw):
        super().__init__("pulp_partition")
        self.params = PulpPartitionParams(**kw)
        self.register((CSR,), lambda f, p: label_prop_partition(f[0], p))
