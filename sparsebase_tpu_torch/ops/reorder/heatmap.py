"""Reorder heatmap: the b×b block density of a (re)ordered matrix.

Counterpart of ``sparsebase_tpu/ops/reorder/heatmap.py`` (reference
``reorder::ReorderHeatmap``, src/sparsebase/reorder/reorder_heatmap.cc:42-120;
params ``ReorderHeatmapParams{num_parts}``). A three-input op on (CSR, row
order, column order), both orders inverse permutations in ``DenseArray`` objects.
Entry (r, c) lands in block ``(min(u // bsize, b - 1), min(v // bsize, b -
1))`` with ``u = order_r[r]``, ``v = order_c[c]`` and ``bsize = n // b``,
the reference's binning (reorder_heatmap.cc:62-87); the density is the
block's count over ``max(nnz, 1)``, float32.

On any device the pass is torch ops on the CSR's own device: one
``bincount`` of ``bu * b + bv`` and the bandwidths ``|u - v|`` in int64. The
stats come back to the host in one read; with ``bincount``'s read of its
largest bin, a call on the card makes three host syncs. Two choices differ
from the JAX package on purpose:

* the grid divides by a 0-d float32 tensor, not a Python int: CUDA would
  multiply by the reciprocal of a Python divisor, and the grid would no
  longer be the one IEEE quotient of the reference's goldens;
* ``mean_bw`` is the exact int64 sum over ``nnz``, where the JAX package
  sums in float32 (``heatmap.py:65``); they agree to float32 rounding.
"""

from __future__ import annotations

import dataclasses

import torch

from ...dispatch import Operation
from ...formats.array import DenseArray
from ...formats.csr import CSR
from ...utils.exceptions import ReorderError


@dataclasses.dataclass
class ReorderHeatmapParams:
    num_parts: int = 8


def _heatmap_pass(formats, params: ReorderHeatmapParams):
    """The density grid and the bandwidth stats in one pass, the reference's
    single loop (reorder_heatmap.cc:70-106) as tensor ops."""
    csr: CSR = formats[0]
    order_r: DenseArray = formats[1]
    order_c: DenseArray = formats[2]
    b = int(params.num_parts)
    n, m = csr.shape
    if b > n or b > m:
        raise ReorderError("Cannot generate heatmap for matrix when num_parts > number of rows or columns")
    dev = csr.indptr.device
    u = order_r.vals.to(dev)[csr.row_of_nnz().long()].to(torch.int64)
    v = order_c.vals.to(dev)[csr.indices.long()].to(torch.int64)
    bsize = n // b
    bu = torch.clamp(u // bsize, max=b - 1)
    bv = torch.clamp(v // bsize, max=b - 1)
    counts = torch.bincount(bu * b + bv, minlength=b * b)
    nnz = max(csr.nnz, 1)
    # a divisor tensor: one IEEE division per block (see the module docstring)
    heat = counts.to(torch.float32) / torch.full((), nnz, dtype=torch.float32, device=dev)
    grid = counts.view(b, b)
    bi = torch.arange(b, device=dev)
    bw = (u - v).abs()
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    bw_sum, bw_max, full, block_sum = torch.stack([
        bw.sum(), bw.max() if csr.nnz else zero, (grid > 0).sum(),
        ((bi[:, None] - bi[None, :]).abs() * grid).sum(),
    ]).tolist()  # the one read of the stats
    stats = {
        "mean_bw": bw_sum / nnz,
        "max_bw": bw_max,
        "num_full_blocks": full,
        "block_mean_bw": block_sum / nnz,
    }
    return DenseArray(heat), stats


def _heatmap_impl(formats, params: ReorderHeatmapParams):
    return _heatmap_pass(formats, params)[0]


class ReorderHeatmap(Operation):
    def __init__(self, num_parts: int = 8):
        super().__init__("reorder_heatmap")
        self.params = ReorderHeatmapParams(num_parts)
        self.register((CSR, DenseArray, DenseArray), _heatmap_impl)
        self._stats_op = Operation("reorder_heatmap_stats")
        self._stats_op.register((CSR, DenseArray, DenseArray), _heatmap_pass)

    def get_heatmap(self, fmt, order_r: DenseArray, order_c: DenseArray, context=None):
        return self.execute(self.params, fmt, order_r, order_c, context=context)

    def get_heatmap_with_stats(self, fmt, order_r: DenseArray, order_c: DenseArray, context=None):
        """``(heatmap, stats)`` in one pass: the mean and largest bandwidth,
        the count of non-empty blocks and the block bandwidth, which the
        reference computes beside the grid (reorder_heatmap.cc:58-59,76-106);
        keys ``mean_bw``, ``max_bw``, ``num_full_blocks``, ``block_mean_bw``."""
        return self._stats_op.execute(self.params, fmt, order_r, order_c, context=context)
