"""Collectives over the shards of one mesh axis, driven from one process.

XLA supplies these to the JAX package (``jax.lax.psum``, ``pmax``, ``pmin``,
``all_to_all``, ``all_gather``, ``psum_scatter``, ``ppermute`` inside
``shard_map``). Here each takes the
sequence of per-shard tensors of one mesh axis, in shard order, and returns
one tensor per shard on that shard's device. A reduction runs on the first
shard's device, in shard order 0..d-1 (integer sums are exact; float sums
take that order), and its result is copied to the other shards' devices;
where shards share a device the result is shared, not copied.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _total(parts: Sequence[torch.Tensor], op) -> torch.Tensor:
    """``op`` folded over the shards in order, on the first shard's device."""
    acc = parts[0]
    for p in parts[1:]:
        acc = op(acc, p.to(acc.device))
    return acc


def _reduce(parts: Sequence[torch.Tensor], op) -> Tuple[torch.Tensor, ...]:
    acc = _total(parts, op)
    return tuple(acc.to(p.device) for p in parts)


def psum(parts: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The sum of the shards' tensors, on every shard."""
    return _reduce(parts, torch.add)


def pmax(parts: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    return _reduce(parts, torch.maximum)


def pmin(parts: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    return _reduce(parts, torch.minimum)


def all_gather(parts: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The shards' tensors stacked in shard order, ``(D, ...)``, on every
    shard (``jax.lax.all_gather``): stacked on the first shard's device and
    copied to the others; where shards share a device the stack is shared."""
    first = parts[0].device
    stacked = torch.stack([p.to(first) for p in parts])
    return tuple(stacked.to(p.device) for p in parts)


def all_to_all(parts: Sequence[torch.Tensor], split_axis: int = 0, concat_axis: int = 0) -> Tuple[torch.Tensor, ...]:
    """Shard s cuts its tensor into d equal pieces along ``split_axis`` and
    sends piece r to shard r, which joins what it receives along
    ``concat_axis`` in shard order (``jax.lax.all_to_all``)."""
    d = len(parts)
    size = parts[0].shape[split_axis]
    if size % d:
        raise ValueError(f"all_to_all: a split axis of {size} does not divide into {d} shards")
    pieces = [p.tensor_split(d, dim=split_axis) for p in parts]
    return tuple(
        torch.cat([pieces[s][r].to(parts[r].device) for s in range(d)], dim=concat_axis) for r in range(d)
    )


def psum_scatter(parts: Sequence[torch.Tensor], scatter_dimension: int = 0, tiled: bool = True) -> Tuple[torch.Tensor, ...]:
    """The sum of the shards' tensors, cut into d equal pieces along
    ``scatter_dimension``: shard r keeps piece r (``tiled``, the dimension
    shrinks d-fold; else the piece's dimension of size 1 is dropped)."""
    d = len(parts)
    size = parts[0].shape[scatter_dimension]
    if size % d or (not tiled and size != d):
        raise ValueError(f"psum_scatter: a dimension of {size} does not scatter over {d} shards")
    pieces = _total(parts, torch.add).tensor_split(d, dim=scatter_dimension)
    if not tiled:
        pieces = [p.squeeze(scatter_dimension) for p in pieces]
    return tuple(piece.to(p.device) for piece, p in zip(pieces, parts))


def ppermute(parts: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]]) -> Tuple[torch.Tensor, ...]:
    """Shard ``dst`` receives ``parts[src]`` for each ``(src, dst)`` pair of
    ``perm`` (``jax.lax.ppermute``), moved to its own device; where the two
    shards share a device it receives the tensor itself, not a copy. A shard
    that no pair names receives zeros."""
    d = len(parts)
    srcs, dsts = [s for s, _ in perm], [t for _, t in perm]
    if not all(0 <= k < d for k in srcs + dsts) or len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute: {list(perm)} is not a permutation of some of {d} shards")
    got = {dst: parts[src].to(parts[dst].device) for src, dst in perm}
    return tuple(got[k] if k in got else torch.zeros_like(parts[k]) for k in range(d))
