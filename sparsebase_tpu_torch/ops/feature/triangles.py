"""Triangle counting.

Counterpart of ``sparsebase_tpu/ops/feature/triangles.py`` (reference
``feature::TriangleCount``, src/sparsebase/feature/triangle_count.cc; params
triangle_count.h:12-16). Semantics, with each distinct edge counted once and
self-loops ignored on every route (``_dedup_adj``; graphkit gets a copy
without them):

* undirected (:177-205): triples u < v < w with edges (u, v), (v, w), (u, w),
  each triangle once, on a symmetric pattern;
* directed (:141-175): 3-cycles u -> v -> w -> u, anchored at their least vertex.

Routes, which give the JAX package's counts:

* CPU tensors: ``native.triangles`` (graphkit) where it builds, else the
  torch host helpers below (a vectorised sorted-list intersection);
* a CUDA CSR, undirected: kernel K6 at every n
  (``sparse_common.triangle_count_sparse_device``); it needs O(nnz) memory,
  so no dense wall applies;
* a CUDA CSR, directed, ``n <= MAX_DEVICE_DENSE_N``: ``_device_dense_count``,
  ``sum(A^T * A^2) / 3`` by one ``torch.matmul``;
* a CUDA CSR, directed, larger n: K6's directed mode
  (``sparse_common.directed_triangle_count_sparse_device``), where the JAX
  package copies the graph to the host.

The JAX package's directed host route counts ``u -> v -> v -> u`` through a
self-loop at ``v`` while its dense tier does not; here every route ignores
self-loops, so a count does not change with the route. Every route returns a
Python int. A CSR with more columns than rows raises ``ValueError`` before
any route: a column id must name a row.
"""

from __future__ import annotations

import dataclasses

import torch

from ...formats.csr import CSR
from ..kernels.common_neighbors import check_ids_name_rows, lower_bound, search_rounds
from .base import Feature

# One n x n float32 matrix at n = 16,384 is 1 GiB; the dense count holds the
# pattern, its square and their product (about 4 GiB with the int64 sum's
# cast) on the card's 80 GB.
MAX_DEVICE_DENSE_N = 16384


@dataclasses.dataclass
class TriangleCountParams:
    count_directed: bool = False


def _ragged_expand(indptr: torch.Tensor, sources: torch.Tensor):
    """``(owner, positions)``: for every entry of the rows ``sources``, the
    index of its source and its position in ``indices``."""
    starts = indptr[sources]
    lens = indptr[sources + 1] - starts
    total = int(lens.sum())
    owner = torch.repeat_interleave(torch.arange(sources.numel()), lens, output_size=total)
    offs = torch.arange(total) - torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens, output_size=total)
    return owner, torch.repeat_interleave(starts, lens, output_size=total) + offs


def _searchsorted_segments(indices: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, targets: torch.Tensor):
    """Per target, its lower bound in the sorted segment ``indices[lo:hi]``,
    relative to ``lo``: a binary search vectorised over the targets."""
    return lower_bound(indices, lo, hi, targets, search_rounds(hi - lo)) - lo


def _count_common_sorted(indptr, indices, a_verts, b_verts) -> torch.Tensor:
    """For each pair (a, b): |N(a) & N(b)|, each element of N(a) searched in
    the sorted N(b)."""
    owner, flat = _ragged_expand(indptr, a_verts)
    cand = indices[flat]
    b_of = b_verts[owner]
    lo, hi = indptr[b_of], indptr[b_of + 1]
    pos = lo + _searchsorted_segments(indices, lo, hi, cand)
    found = (pos < hi) & (indices[pos.clamp(max=max(indices.numel() - 1, 0))] == cand)
    return torch.bincount(owner[found], minlength=a_verts.numel())


def _dedup_adj(indptr: torch.Tensor, indices: torch.Tensor, n: int):
    """The unique (row, col) pairs off the diagonal as an int64 ``(indptr,
    indices)``: every route counts each distinct edge once and ignores
    self-loops. The reference iterates the first two lists and dedups only
    the closing edge, so duplicated entries multiply its count
    (triangle_count.cc:190-203)."""
    row = torch.repeat_interleave(torch.arange(n, dtype=torch.int64), indptr[1:] - indptr[:-1])
    off = row != indices
    keys = torch.unique(row[off] * n + indices[off])
    r, c = keys // n, keys % n
    ip = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(torch.bincount(r, minlength=n), 0)])
    return ip, c


def _host_adj(csr: CSR):
    return _dedup_adj(csr.indptr.cpu().to(torch.int64), csr.indices.cpu().to(torch.int64), csr.nrows)


def _without_loops(csr: CSR) -> CSR:
    """The CSR's pattern (CPU tensors) with its diagonal entries dropped."""
    row = csr.row_of_nnz()
    off = row != csr.indices
    counts = torch.bincount(row[off].to(torch.int64), minlength=csr.nrows)
    indptr = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(counts, 0)])
    return CSR(indptr, csr.indices[off], None, csr.shape)


def _undirected_count(csr: CSR) -> int:
    """Triples u < v < w: for each edge (v, w) with v < w, the common
    predecessors u < v of v and w."""
    n = csr.nrows
    indptr, indices = _host_adj(csr)
    row = torch.repeat_interleave(torch.arange(n, dtype=torch.int64), indptr[1:] - indptr[:-1])
    mask = indices > row  # successor edges
    lv, lw = row[mask], indices[mask]
    s_counts = torch.bincount(lv, minlength=n)
    s_indices = indices[mask]  # grouped by row, sorted within each
    # predecessor lists: the transpose of the successor graph, sorted
    p_indptr = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(torch.bincount(s_indices, minlength=n), 0)])
    order = torch.argsort(s_indices, stable=True)
    p_indices = torch.repeat_interleave(torch.arange(n, dtype=torch.int64), s_counts)[order]
    return int(_count_common_sorted(p_indptr, p_indices, lv, lw).sum())


def _directed_count(csr: CSR) -> int:
    """Directed 3-cycles u -> v -> w -> u anchored at their least vertex u."""
    n = csr.nrows
    indptr, indices = _host_adj(csr)
    row = torch.repeat_interleave(torch.arange(n, dtype=torch.int64), indptr[1:] - indptr[:-1])
    mask = indices > row  # edges u -> v with u < v; then w in N(v), w > u, with w -> u
    eu, ev = row[mask], indices[mask]
    owner, flat = _ragged_expand(indptr, ev)
    w = indices[flat]
    u_of = eu[owner]
    lo, hi = indptr[w], indptr[w + 1]
    pos = lo + _searchsorted_segments(indices, lo, hi, u_of)
    found = (pos < hi) & (indices[pos.clamp(max=max(indices.numel() - 1, 0))] == u_of)
    return int(((w > u_of) & found).sum())


def _device_dense_count(csr: CSR, directed: bool) -> int:
    """Triangles as entries of A^2: ``sum(A * A^2) / 6`` (undirected,
    symmetric A) or ``sum(A^T * A^2) / 3`` (directed 3-cycles), with A the
    0/1 pattern, its diagonal cleared. The operands are float32: a product or
    sum of 0/1 values stays exact in float32, TF32 included, while the counts
    stay below 2^24 (an entry of A^2 is at most n). bf16 operands would let
    cuBLAS reduce in reduced precision. The product is summed as int64."""
    n = csr.nrows
    dev = csr.indptr.device
    row, col = csr.row_of_nnz().to(torch.int64), csr.indices.to(torch.int64)
    keep = col < n
    dense = torch.zeros((n, n), dtype=torch.float32, device=dev)
    dense[row[keep], col[keep]] = 1.0
    dense.fill_diagonal_(0.0)
    sq = torch.matmul(dense, dense)
    sq.mul_(dense.T if directed else dense)
    return int(sq.sum(dtype=torch.int64)) // (3 if directed else 6)


class TriangleCount(Feature):
    def __init__(self, count_directed: bool = False):
        super().__init__("triangle_count")
        self.params = TriangleCountParams(count_directed)
        self.register((CSR,), self._impl)

    @staticmethod
    def _impl(formats, params: TriangleCountParams) -> int:
        csr: CSR = formats[0]
        check_ids_name_rows(csr)  # before any route: graphkit and the recast to (n, n) would read past indptr
        if csr.indptr.device.type != "cpu":
            from . import sparse_common

            if not params.count_directed:
                return sparse_common.triangle_count_sparse_device(csr)
            if csr.nrows <= MAX_DEVICE_DENSE_N:
                return _device_dense_count(csr, True)
            return sparse_common.directed_triangle_count_sparse_device(csr)
        from ... import native

        if native.available():
            h = _without_loops(csr)
            return native.triangles(h.nrows, h.indptr, h.indices, params.count_directed)
        return _directed_count(csr) if params.count_directed else _undirected_count(csr)

    def get_triangle_count(self, fmt, context=None, convert_input=True):
        return self.execute(self.params, fmt, context=context, convert_input=convert_input)
