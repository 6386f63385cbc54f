"""Partitioner base: operations that give each vertex a part.

Counterpart of ``sparsebase_tpu/ops/partition/base.py`` (reference
src/sparsebase/partition/partitioner.h:23-36). Every partitioner returns
``part[vertex] = part_id`` in ``[0, num_partitions)``, as an int32 tensor on
the input's device.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ...context import Context
from ...dispatch import Operation
from ...formats.base import Format
from ...formats.csr import CSR
from ..kernels.label_prop import part_counts


class Partitioner(Operation):
    """Base class; subclasses register per-format implementations in their
    constructor and set ``self.params``."""

    params: Any = None

    def partition(self, fmt: Format, context: Optional[Context] = None, convert_input: bool = True):
        """Vertex → part labels (Partitioner::Partition)."""
        return self.execute(self.params, fmt, context=context, convert_input=convert_input)


def as_labels(labels, device) -> torch.Tensor:
    """``labels`` (a tensor, a numpy array or a list) as a tensor on ``device``;
    a tensor stays where it is when ``device`` is None."""
    if isinstance(labels, torch.Tensor):
        return labels if device is None else labels.to(device)
    return torch.as_tensor(np.asarray(labels), device=device)


def edge_cut(csr: CSR, labels) -> int:
    """Entries whose two ends lie in different parts, halved: each edge of a
    symmetric matrix once. One read of the count."""
    labels = as_labels(labels, csr.indptr.device)
    row = csr.row_of_nnz().long()
    cut = (labels[row] != labels[csr.indices.long()]).sum()
    return int(cut) // 2


def part_sizes(labels, num_parts: int, weights=None) -> torch.Tensor:
    """Vertices (or their summed ``weights``) per part, on the labels'
    device: int64, float64 with weights. A label outside ``[0, num_parts)``
    is dropped, where ``np.bincount`` raises on a negative one and
    ``jnp.bincount`` counts it in part 0. A ``scatter_add_`` into
    ``zeros(num_parts)``: ``torch.bincount`` reads its range on the host."""
    labels = as_labels(labels, None).long()
    if weights is None:
        return part_counts(labels, num_parts)
    valid = (labels >= 0) & (labels < num_parts)
    w = as_labels(weights, labels.device).to(torch.float64)
    out = torch.zeros((num_parts,), dtype=torch.float64, device=labels.device)
    return out.scatter_add_(0, torch.where(valid, labels, 0), torch.where(valid, w, 0.0))


def balance_ratio(labels, num_parts: int) -> float:
    """Largest part's size over the ideal size ``n / num_parts``."""
    labels = as_labels(labels, None)
    sizes = part_sizes(labels, num_parts)
    return float(int(sizes.max()) * num_parts / max(labels.shape[0], 1))
