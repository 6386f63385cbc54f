"""Plain torch: rounds of size-constrained label propagation from contiguous
chunks, every round run (SparseBase's PULP-style partitioner as
``models.partition_pipeline`` states it).

Imports nothing of the program. For each row ``r``, with labels in
``[0, k)``:

* ``counts[r, p]``: the entries of row ``r`` whose column is labelled ``p``;
* ``sizes[p]``: the vertices labelled ``p``;
* ``pen[p] = alpha * max(sizes[p] - cap, 0) * (max(counts) + 1) / max(cap, 1)``
  in float32, in that order, every Python number rounded to float32 first,
  ``max(counts)`` over all ``(r, p)``; round ``i`` of ``R`` (from 0) has
  ``alpha = (i + 1) / R``, and ``cap = 1.1 n / k``;
* the new label of ``r``: the first ``p`` of the largest
  ``counts[r, p] - pen[p]`` (float32); a row with no entries keeps its label.

Counts are integers, so the labels are exact.
"""

from __future__ import annotations

import torch

BLOCK = 1 << 26  # entries at a time


def chunks(n: int, k: int, device) -> torch.Tensor:
    """``(v * k) // n`` for each vertex ``v``."""
    return (torch.arange(n, dtype=torch.int64, device=device) * k) // max(n, 1)


def _f32(value: float, device) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=device)


def one_round(row: torch.Tensor, col: torch.Tensor, degree: torch.Tensor, labels: torch.Tensor, k: int,
              alpha: float, cap: float) -> torch.Tensor:
    n, dev = labels.numel(), labels.device
    counts = torch.zeros((n * k,), dtype=torch.int32, device=dev)
    for lo in range(0, row.numel(), BLOCK):
        cell = row[lo:lo + BLOCK].long() * k + labels[col[lo:lo + BLOCK].long()]
        counts.index_add_(0, cell, torch.ones_like(cell, dtype=torch.int32))
    counts = counts.view(n, k).to(torch.float32)
    sizes = torch.bincount(labels, minlength=k)[:k].to(torch.float32)
    over = torch.clamp_min(sizes - _f32(cap, dev), 0.0)
    pen = _f32(alpha, dev) * over * (counts.amax() + 1.0) / _f32(max(cap, 1.0), dev)
    new = torch.argmax(counts - pen[None, :], dim=1)
    return torch.where(degree > 0, new, labels)


def propagate(row: torch.Tensor, col: torch.Tensor, degree: torch.Tensor, n: int, k: int, rounds: int) -> torch.Tensor:
    """The labels (int64) after ``rounds`` rounds from contiguous chunks."""
    labels = chunks(n, k, row.device)
    cap = 1.1 * n / k
    for i in range(rounds):
        labels = one_round(row, col, degree, labels, k, (i + 1) / rounds, cap)
    return labels
