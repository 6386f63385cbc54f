"""Hypergraph partitioning (PaToH-equivalent) on the column-net model.

Counterpart of ``sparsebase_tpu/ops/partition/hypergraph.py`` (reference
``partition::PatohPartition``, src/sparsebase/partition/
patoh_partition.cc:31-130, which builds column nets from a CSR, net ``j`` =
the rows with an entry in column ``j`` and a cell's weight its row degree,
and calls ``PaToH_Part``). The partitioner is connectivity-driven label
propagation on the cell and net structure, then a balance fix-up and FM
passes on the exact connectivity-1 gains (PaToH's default metric,
:func:`cutsize_connectivity`).

A host algorithm by design (the FM passes apply one move at a time), in
numpy, the JAX package's route line for line. The model's arrays
(:func:`column_net_hypergraph`) are numpy arrays on the host; a CUDA CSR is
copied there once, and the labels go back to the input's device as int32
(:meth:`PatohPartition.partition_hypergraph`: to the device of the
hypergraph's connectivity).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...formats.csr import CSR
from ...objects import HyperGraph
from .base import Partitioner


@dataclasses.dataclass
class PatohPartitionParams:
    """The fields of PatohPartitionParams (patoh_partition.h). ``seed`` is
    kept for the reference's constructor and **ignored**: the initial
    assignment is a deterministic weighted chunking, so nothing is random."""

    num_partitions: int = 2
    final_imbalance: float = 0.1
    seed: int = 42  # the reference's field; the partitioner is deterministic
    num_iterations: int = 20
    refine_rounds: int = 8


def _host(a) -> np.ndarray:
    """A tensor (on any device) or an array-like as a numpy array."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def column_net_hypergraph(csr: CSR):
    """The column-net model of a CSR (patoh_partition.cc:31-60): nets are
    columns, the pins of net ``j`` the rows with an entry in column ``j``, a
    cell's weight its row's degree. ``(net_indptr int64, pins int64,
    cell_weights float64)``, numpy arrays on the host."""
    from ..reorder._host import host_arrays

    indptr, indices = host_arrays(csr)
    n, m = csr.shape
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    order = np.argsort(indices, kind="stable")
    pins = row[order]
    counts = np.bincount(indices, minlength=m)
    net_indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    cell_weights = np.diff(indptr).astype(np.float64)
    return net_indptr, pins, cell_weights


def cutsize_connectivity(net_indptr, pins, labels, k) -> int:
    """The sum over nets of (parts the net touches - 1); any argument may be
    a tensor or a numpy array."""
    net_indptr, pins, labels = _host(net_indptr), _host(pins), _host(labels)
    n_nets = len(net_indptr) - 1
    net_of = np.repeat(np.arange(n_nets, dtype=np.int64), np.diff(net_indptr))
    present = np.zeros((n_nets, k), bool)
    present[net_of, labels[pins]] = True
    lam = present.sum(axis=1)
    lam = np.where(np.diff(net_indptr) > 0, lam, 1)
    return int((lam - 1).sum())


def _net_counts(net_of, pins, labels, n_nets, k):
    counts = np.zeros((n_nets, k), np.int32)
    np.add.at(counts, (net_of, labels[pins]), 1)
    return counts


def _fm_round(net_indptr, net_of, pins, cell_weights, labels, sizes, cap, k, max_moves):
    """One FM-style pass on the connectivity-1 objective.

    Exact move gain (cell v: p → q) over v's nets j:
    ``gain = Σ_j [count(j, p) == 1] − Σ_j [count(j, q) == 0]`` — the net
    leaves p entirely (λ−1) iff v was its only pin there, and newly
    touches q (λ+1) iff it had none. Candidates with gain ≥ 0 (zero-gain
    moves wander plateaus — the round-3 graph-anchor lesson) are applied
    greedily best-first with live net-count/size updates, so every
    accepted move's gain is exact at acceptance time."""
    n_nets = len(net_indptr) - 1
    n_cells = len(labels)
    counts = _net_counts(net_of, pins, labels, n_nets, k)
    lp = labels[pins]
    # A_v = Σ_{j ∋ v} [count(j, label_v) == 1]
    a_pin = counts[net_of, lp] == 1
    A = np.zeros(n_cells, np.int32)
    np.add.at(A, pins, a_pin.astype(np.int32))
    # B_{v,q} = Σ_{j ∋ v} [count(j, q) == 0]
    B = np.zeros((n_cells, k), np.int32)
    np.add.at(B, pins, (counts[net_of] == 0).astype(np.int32))
    G = A[:, None] - B  # gain of moving v to q (invalid at q == label_v)
    G[np.arange(n_cells), labels] = np.iinfo(np.int32).min
    best_q = np.argmax(G, axis=1)
    best_g = G[np.arange(n_cells), best_q]
    cand = np.nonzero(best_g >= 0)[0]
    if len(cand) == 0:
        return 0
    order = cand[np.argsort(-best_g[cand], kind="stable")][:max_moves]
    # cell → nets adjacency for live gain re-evaluation
    pin_order = np.argsort(pins, kind="stable")
    cell_net_indptr = np.concatenate(
        [[0], np.cumsum(np.bincount(pins, minlength=n_cells))]
    )
    nets_by_cell = net_of[pin_order]
    moved = 0
    for v in order:
        p = int(labels[v])
        nets_v = nets_by_cell[cell_net_indptr[v] : cell_net_indptr[v + 1]]
        row = counts[nets_v]
        gains = (row[:, p] == 1).sum() - (row == 0).sum(axis=0)
        gains[p] = np.iinfo(np.int32).min
        q = int(np.argmax(gains))
        if gains[q] < 0:
            continue
        if sizes[q] + cell_weights[v] > cap:
            # try the best feasible alternative
            feas = [
                (gains[q2], q2)
                for q2 in range(k)
                if q2 != p and gains[q2] >= 0 and sizes[q2] + cell_weights[v] <= cap
            ]
            if not feas:
                continue
            _, q = max(feas)
        labels[v] = q
        counts[nets_v, p] -= 1
        counts[nets_v, q] += 1
        sizes[p] -= cell_weights[v]
        sizes[q] += cell_weights[v]
        moved += 1
    return moved


def hypergraph_label_prop(net_indptr, pins, cell_weights, params: PatohPartitionParams):
    """Connectivity-driven label propagation + FM refinement on the
    column-net hypergraph. Deterministic balanced init (weighted
    contiguous chunks — exploits index locality like PaToH's recursive
    bisection start), PULP-style tightening label prop, then FM passes
    on the exact λ−1 gains with best-feasible tracking."""
    n_nets = len(net_indptr) - 1
    n_cells = int(cell_weights.shape[0])
    k = int(params.num_partitions)
    if k <= 1 or n_cells == 0:
        return np.zeros(n_cells, np.int32)
    net_of = np.repeat(np.arange(n_nets, dtype=np.int64), np.diff(net_indptr))
    total_w = float(cell_weights.sum())
    cap = (1.0 + params.final_imbalance) * total_w / k
    # init: weighted contiguous chunks (prefix deal) — balanced by
    # construction and locality-aware for index-ordered inputs
    wpfx = np.cumsum(cell_weights) - cell_weights / 2.0
    labels = np.minimum(
        (wpfx / max(total_w, 1e-30) * k).astype(np.int64), k - 1
    )
    for it in range(params.num_iterations):
        net_counts = _net_counts(net_of, pins, labels, n_nets, k).astype(np.float32)
        cell_aff = np.zeros((n_cells, k), np.float32)
        np.add.at(cell_aff, pins, net_counts[net_of])
        sizes = np.zeros(k, np.float64)
        np.add.at(sizes, labels, cell_weights)
        alpha = (it + 1) / params.num_iterations
        penalty = alpha * np.maximum(sizes - cap, 0.0) * (cell_aff.max() + 1.0) / max(cap, 1.0)
        scores = cell_aff - penalty[None, :].astype(np.float32)
        new_labels = np.argmax(scores, axis=1).astype(np.int64)
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
    # balance fixup: evict lowest connectivity-loss cells from oversized
    # parts into the lightest parts until every part fits the cap
    sizes = np.zeros(k, np.float64)
    np.add.at(sizes, labels, cell_weights)
    net_counts = _net_counts(net_of, pins, labels, n_nets, k).astype(np.float32)
    cell_aff = np.zeros((n_cells, k), np.float32)
    np.add.at(cell_aff, pins, net_counts[net_of])
    for p in np.argsort(-sizes):
        if sizes[p] <= cap:
            continue
        members = np.nonzero(labels == p)[0]
        # loss of leaving p, lowest first (ties: lightest weight first)
        loss = cell_aff[members, p] - cell_aff[members].max(axis=1)
        order = np.lexsort((cell_weights[members], loss))
        for idx in order:
            if sizes[p] <= cap:
                break
            v = int(members[idx])
            tgt = int(np.argmin(np.where(np.arange(k) == p, np.inf, sizes)))
            if sizes[tgt] + cell_weights[v] > cap:
                continue
            labels[v] = tgt
            sizes[p] -= cell_weights[v]
            sizes[tgt] += cell_weights[v]
    # FM refinement with best-feasible tracking (anchors exposed pure
    # label prop stalling 2-4x off the tiling optima, like the graph
    # partitioner before round 3's zero-gain fix)
    best = labels.copy()
    best_cut = cutsize_connectivity(net_indptr, pins, labels, k)
    max_moves = max(64, n_cells // 4)
    for _ in range(max(int(params.refine_rounds), 0)):
        sizes = np.zeros(k, np.float64)
        np.add.at(sizes, labels, cell_weights)
        moved = _fm_round(
            net_indptr, net_of, pins, cell_weights, labels, sizes, cap, k, max_moves
        )
        cut = cutsize_connectivity(net_indptr, pins, labels, k)
        feasible = sizes.max() <= cap + 1e-9
        if feasible and cut < best_cut:
            best, best_cut = labels.copy(), cut
        if moved == 0:
            break
    return best.astype(np.int32)


class PatohPartition(Partitioner):
    """Hypergraph partitioner on the column-net model. Takes a CSR (its
    column nets are built, as the reference does), or a
    :class:`HyperGraph` through :meth:`partition_hypergraph`."""

    def __init__(self, **kw):
        super().__init__("patoh_partition")
        self.params = PatohPartitionParams(**kw)
        self.register((CSR,), self._impl)

    @staticmethod
    def _impl(formats, params):
        from ..reorder._host import to_order

        net_indptr, pins, cw = column_net_hypergraph(formats[0])
        return to_order(hypergraph_label_prop(net_indptr, pins, cw, params), formats[0])

    def partition_hypergraph(self, hg: HyperGraph) -> torch.Tensor:
        """Labels of a HyperGraph's cells, int32 on its connectivity's device."""
        con = hg.connectivity.as_format(CSR)
        net_indptr = _host(con.indptr).astype(np.int64)
        pins = _host(con.indices).astype(np.int64) - hg.base_type
        if hg.cell_weights is not None:
            cw = _host(hg.cell_weights.vals).astype(np.float64)
        else:
            cw = np.ones(hg.num_cells, np.float64)
        labels = hypergraph_label_prop(net_indptr, pins, cw, self.params)
        return torch.from_numpy(labels).to(con.indptr.device)
