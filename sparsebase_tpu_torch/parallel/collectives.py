"""Collectives over the shards of one mesh axis.

XLA supplies these to the JAX package (``jax.lax.psum``, ``pmax``, ``pmin``,
``all_to_all``, ``all_gather``, ``psum_scatter``, ``ppermute`` inside
``shard_map``). Here each takes the
sequence of per-shard tensors of one mesh axis, in shard order, and returns
one tensor per shard on that shard's device. A reduction runs on the first
shard's device, in shard order 0..d-1 (integer sums are exact; float sums
take that order), and its result is copied to the other shards' devices;
where shards share a device the result is shared, not copied.

On a mesh that spans processes (``owners``, the shards' owner ranks, name
more than one process) a process passes its own shards' tensors and
``None`` in a remote shard's slot, and receives its own shards' results
(``None`` again elsewhere). What crosses a process boundary goes through
``torch.distributed`` as byte blobs (a header of dtypes and shapes, then the
tensors), so parts of any dtype and of shapes that differ across shards
move in one ``all_to_all_single`` after one of their sizes. A reduction
gathers every part and folds them in shard order 0..d-1 on the process's
first shard's device, so its float sums equal the single-process mesh's
bit for bit. With gloo a CUDA tensor is staged through host memory. The
bytes sent to other processes and the bytes staged are counted
(:func:`traffic`). Inside a process, the bytes that :func:`all_to_all`
copies from one card to another go to the counter
``collectives.card_bytes`` (``utils.tracing.count``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..utils.tracing import count

# bytes this process sent to other processes, bytes staged between a card
# and host memory for gloo, and the exchanges made (reset_traffic, traffic)
_TRAFFIC = {"crossed_bytes": 0, "staged_bytes": 0, "exchanges": 0}
_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int64, torch.int32, torch.int16,
           torch.int8, torch.uint8, torch.bool)
_ALIGN = 8


def reset_traffic() -> None:
    for key in _TRAFFIC:
        _TRAFFIC[key] = 0


def traffic() -> dict:
    """What crossed a process boundary since :func:`reset_traffic`:
    ``crossed_bytes`` (sent by this process, headers included),
    ``staged_bytes`` (copied between a card and host memory for gloo, both
    ways) and ``exchanges``."""
    return dict(_TRAFFIC)


def _spans(owners) -> bool:
    return owners is not None and len(set(owners)) > 1


def _layout(parts, owners):
    """``(my rank, {rank: its shards in order}, my first shard's device)``
    of a spanning call; checks that the parts are exactly this process's."""
    import torch.distributed as tdist

    me = tdist.get_rank()
    if len(parts) != len(owners):
        raise ValueError(f"{len(parts)} parts for {len(owners)} shards")
    by_rank = {}
    for k, o in enumerate(owners):
        by_rank.setdefault(o, []).append(k)
        if (parts[k] is None) == (o == me):
            raise ValueError(f"shard {k} of rank {o}: rank {me} must pass a tensor for its own shards and None "
                             "for the others'")
    k = by_rank[me][0]
    return me, by_rank, _device(parts[k], k)


def _device(part, k: int) -> torch.device:
    """Shard ``k``'s device: its tensor's, or that of its own piece where
    the part is a sequence of pieces (:func:`all_to_all`)."""
    return part.device if isinstance(part, torch.Tensor) else part[k].device


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s raw bytes, padded to a multiple of ``_ALIGN``."""
    raw = t.contiguous().reshape(-1).view(torch.uint8)
    pad = -raw.numel() % _ALIGN
    return torch.cat([raw, raw.new_zeros((pad,))]) if pad else raw


def _pack(tensors: Sequence[torch.Tensor], home: torch.device) -> torch.Tensor:
    """One uint8 blob on ``home``: the header's length, the header (each
    tensor's dtype, rank and shape, int64) and each tensor's bytes."""
    header = [len(tensors)]
    for t in tensors:
        header += [_DTYPES.index(t.dtype), t.dim(), *t.shape]
    pieces = [torch.tensor([len(header)] + header, dtype=torch.int64).view(torch.uint8).to(home)]
    for t in tensors:
        raw = _bytes(t)
        if raw.device != home:
            _TRAFFIC["staged_bytes"] += raw.numel()
            raw = raw.to(home)
        pieces.append(raw)
    return torch.cat(pieces)


def _unpack(blob: torch.Tensor) -> List[torch.Tensor]:
    """The tensors of a blob of :func:`_pack`, as views of it."""
    length = int(blob[:8].view(torch.int64))
    header = blob[8 : 8 * (length + 1)].view(torch.int64).tolist()
    out, at, i = [], 8 * (length + 1), 1
    for _ in range(header[0]):
        dtype, ndim = _DTYPES[header[i]], header[i + 1]
        shape = header[i + 2 : i + 2 + ndim]
        i += 2 + ndim
        size = torch.Size(shape).numel() * torch.empty((), dtype=dtype).element_size()
        out.append(blob[at : at + size].view(dtype).view(shape))
        at += size + (-size % _ALIGN)
    return out


def _home(device: torch.device) -> torch.device:
    """Where blobs travel: host memory under gloo, the card under NCCL."""
    import torch.distributed as tdist

    return torch.device("cpu") if tdist.get_backend() == "gloo" else device


def _swap(sends: dict, device: torch.device) -> dict:
    """Send ``sends[q]`` (tensors) to every other process q and receive
    theirs: ``{p: the tensors p sent here}``, as views of one received
    buffer in host memory (gloo) or on ``device`` (NCCL). Every process of
    the group must call it at once."""
    import torch.distributed as tdist

    world, me = tdist.get_world_size(), tdist.get_rank()
    home = _home(device)
    blobs = [_pack(sends.get(q, ()), home) if q != me else torch.zeros((0,), dtype=torch.uint8, device=home)
             for q in range(world)]
    send_sizes = torch.tensor([b.numel() for b in blobs], dtype=torch.int64, device=home)
    recv_sizes = torch.empty_like(send_sizes)
    tdist.all_to_all_single(recv_sizes, send_sizes)
    sizes = recv_sizes.tolist()
    recv = torch.empty((sum(sizes),), dtype=torch.uint8, device=home)
    tdist.all_to_all_single(recv, torch.cat(blobs), sizes, send_sizes.tolist())
    _TRAFFIC["crossed_bytes"] += int(sum(b.numel() for b in blobs)) + 8 * (world - 1)
    _TRAFFIC["exchanges"] += 1
    got, at = {}, 0
    for p, size in enumerate(sizes):
        if p != me:
            got[p] = _unpack(recv[at : at + size])
        at += size
    return got


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``; a copy from host memory to a card counts as staged."""
    if t.device != device and t.device.type == "cpu":
        _TRAFFIC["staged_bytes"] += t.numel() * t.element_size()
    return t.to(device)


def _everyone(parts, owners) -> Tuple[list, torch.device]:
    """Every shard's tensor, in shard order: this process's as they are,
    the others' received on its first shard's device."""
    me, by_rank, first = _layout(parts, owners)
    mine = [parts[k] for k in by_rank[me]]
    got = _swap({q: mine for q in by_rank}, first)
    out = list(parts)
    for p, tensors in got.items():
        for k, t in zip(by_rank[p], tensors):
            out[k] = _to(t, first)
    return out, first


def gather(parts: Sequence[Optional[torch.Tensor]], owners=None, device=None) -> list:
    """Every shard's tensor, in shard order, on ``device`` (default: the
    first shard's, on a spanning mesh this process's first shard's); the
    shapes may differ."""
    if not _spans(owners):
        device = parts[0].device if device is None else device
        return [p.to(device) for p in parts]
    every, first = _everyone(parts, owners)
    device = first if device is None else device
    return [p.to(device) for p in every]


def join(parts: Sequence[Optional[torch.Tensor]], owners=None, device=None) -> torch.Tensor:
    """The shards' tensors concatenated in shard order on ``device`` (as :func:`gather`)."""
    return torch.cat(gather(parts, owners, device))


def host_fetch(parts: Sequence[Optional[torch.Tensor]], owners=None) -> list:
    """Every shard's tensor read back to the host in one read, in shard
    order (``tolist`` of their stack; the parts share a shape). On a mesh
    that spans processes the remote parts are gathered over the group
    first, so every process reads the same values (the counterpart of the
    JAX module's ``_host_fetch`` and its ``process_allgather``)."""
    return torch.stack(gather(parts, owners)).tolist()


def share(parts: Sequence[Optional[tuple]], owners, readers: Sequence, device: torch.device) -> list:
    """Shard k's part, a tuple of tensors (as many for every shard), on
    every process of ``readers[k]`` (a set of ranks): ``out[k]`` is this
    process's own part, or the part received on ``device``, where it is a
    reader of shard k, else None; a received tensor owns its memory. One
    exchange moves every part whose owner and reader differ, so groups of
    shards that span different processes share theirs in one call, which
    every process of the group makes. Off a spanning mesh it returns
    ``parts`` as they are."""
    if not _spans(owners):
        return list(parts)
    import torch.distributed as tdist

    me = tdist.get_rank()

    def moved(p, q):  # the shards that p sends to q, in shard order
        return [k for k, o in enumerate(owners) if o == p and q in readers[k]]

    sends = {q: [t for k in moved(me, q) for t in parts[k]] for q in range(tdist.get_world_size()) if q != me}
    out = [parts[k] if o == me else None for k, o in enumerate(owners)]
    for p, tensors in _swap(sends, device).items():
        ks = moved(p, me)
        width = len(tensors) // max(len(ks), 1)
        for at, k in enumerate(ks):
            out[k] = tuple(_own(t, device) for t in tensors[at * width : (at + 1) * width])
    return out


def _own(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` (a view of a received buffer) on ``device`` in memory of its
    own, so that a part kept does not hold the whole buffer."""
    moved = _to(t, device)
    return moved.clone() if moved is t else moved


def _total(parts: Sequence[torch.Tensor], op) -> torch.Tensor:
    """``op`` folded over the shards in order, on the first shard's device."""
    acc = parts[0]
    for p in parts[1:]:
        acc = op(acc, p.to(acc.device))
    return acc


def _reduce(parts, op, owners) -> Tuple[Optional[torch.Tensor], ...]:
    every = _everyone(parts, owners)[0] if _spans(owners) else parts
    acc = _total(every, op)
    return tuple(None if p is None else acc.to(p.device) for p in parts)


def psum(parts: Sequence[Optional[torch.Tensor]], owners=None) -> Tuple[Optional[torch.Tensor], ...]:
    """The sum of the shards' tensors, on every shard."""
    return _reduce(parts, torch.add, owners)


def pmax(parts: Sequence[Optional[torch.Tensor]], owners=None) -> Tuple[Optional[torch.Tensor], ...]:
    return _reduce(parts, torch.maximum, owners)


def pmin(parts: Sequence[Optional[torch.Tensor]], owners=None) -> Tuple[Optional[torch.Tensor], ...]:
    return _reduce(parts, torch.minimum, owners)


def all_gather(parts: Sequence[Optional[torch.Tensor]], owners=None) -> Tuple[Optional[torch.Tensor], ...]:
    """The shards' tensors stacked in shard order, ``(D, ...)``, on every
    shard (``jax.lax.all_gather``): stacked on the first shard's device and
    copied to the others; where shards share a device the stack is shared."""
    stacked = torch.stack(gather(parts, owners))
    return tuple(None if p is None else stacked.to(p.device) for p in parts)


def all_to_all(parts: Sequence, split_axis: int = 0, concat_axis: int = 0,
               owners=None) -> Tuple[Optional[torch.Tensor], ...]:
    """Shard s sends its piece r to shard r, which joins what it receives
    along ``concat_axis`` in shard order (``jax.lax.all_to_all``). A part is
    a tensor, cut into d equal pieces along ``split_axis``, or a sequence of
    d pieces whose sizes along ``concat_axis`` may differ (piece r of shard
    r lies on its device): an all-to-all of true lengths, with no padded
    bucket. Each piece is copied once, into its place in the joined tensor;
    across processes, the pieces between two processes travel in one
    exchange. A copy between two cards inside a process counts its bytes
    in ``collectives.card_bytes``."""
    d = len(parts)
    pieces = [None if p is None else _cut(p, d, split_axis) for p in parts]
    if not _spans(owners):
        return tuple(_joined([pieces[s][r] for s in range(d)], _device(parts[r], r), concat_axis) for r in range(d))
    me, by_rank, first = _layout(parts, owners)
    got = _swap({q: [pieces[s][r] for s in by_rank[me] for r in ks] for q, ks in by_rank.items()}, first)
    recv = {}  # (s, r) -> the piece shard s sent to this process's shard r
    for p, tensors in got.items():
        pairs = [(s, r) for s in by_rank[p] for r in by_rank[me]]
        recv.update(zip(pairs, tensors))
    return tuple(
        None if parts[r] is None else _joined([recv[s, r] if parts[s] is None else pieces[s][r] for s in range(d)],
                                              _device(parts[r], r), concat_axis)
        for r in range(d)
    )


def _cut(part, d: int, axis: int) -> tuple:
    """A shard's part as its d pieces."""
    if isinstance(part, torch.Tensor):
        if part.shape[axis] % d:
            raise ValueError(f"all_to_all: a split axis of {part.shape[axis]} does not divide into {d} shards")
        return part.tensor_split(d, dim=axis)
    if len(part) != d:
        raise ValueError(f"all_to_all: {len(part)} pieces for {d} shards")
    return tuple(part)


def _joined(pieces: Sequence[torch.Tensor], device: torch.device, axis: int) -> torch.Tensor:
    """The pieces joined along ``axis`` on ``device``, each copied once into
    its place: a copy from host memory to a card counts as staged, one
    between two cards as ``collectives.card_bytes``."""
    shape = list(pieces[0].shape)
    shape[axis] = sum(p.shape[axis] for p in pieces)
    out = torch.empty(shape, dtype=pieces[0].dtype, device=device)
    at = 0
    for p in pieces:
        size = p.shape[axis]
        if size:
            out.narrow(axis, at, size).copy_(p)
            if p.device != device:
                nbytes = p.numel() * p.element_size()
                if p.device.type == "cpu":
                    _TRAFFIC["staged_bytes"] += nbytes
                elif device.type == "cuda":
                    count("collectives.card_bytes", nbytes)
        at += size
    return out


def psum_scatter(parts: Sequence[Optional[torch.Tensor]], scatter_dimension: int = 0, tiled: bool = True,
                 owners=None) -> Tuple[Optional[torch.Tensor], ...]:
    """The sum of the shards' tensors, cut into d equal pieces along
    ``scatter_dimension``: shard r keeps piece r (``tiled``, the dimension
    shrinks d-fold; else the piece's dimension of size 1 is dropped)."""
    d = len(parts)
    size = next(p for p in parts if p is not None).shape[scatter_dimension]
    if size % d or (not tiled and size != d):
        raise ValueError(f"psum_scatter: a dimension of {size} does not scatter over {d} shards")
    every = _everyone(parts, owners)[0] if _spans(owners) else parts
    pieces = _total(every, torch.add).tensor_split(d, dim=scatter_dimension)
    if not tiled:
        pieces = [p.squeeze(scatter_dimension) for p in pieces]
    return tuple(None if p is None else piece.to(p.device) for piece, p in zip(pieces, parts))


def ppermute(parts: Sequence[Optional[torch.Tensor]], perm: Sequence[Tuple[int, int]],
             owners=None) -> Tuple[Optional[torch.Tensor], ...]:
    """Shard ``dst`` receives ``parts[src]`` for each ``(src, dst)`` pair of
    ``perm`` (``jax.lax.ppermute``), moved to its own device; where the two
    shards share a device it receives the tensor itself, not a copy. A shard
    that no pair names receives zeros."""
    d = len(parts)
    srcs, dsts = [s for s, _ in perm], [t for _, t in perm]
    if not all(0 <= k < d for k in srcs + dsts) or len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute: {list(perm)} is not a permutation of some of {d} shards")
    if not _spans(owners):
        got = {dst: parts[src].to(parts[dst].device) for src, dst in perm}
        return tuple(got[k] if k in got else torch.zeros_like(parts[k]) for k in range(d))
    me, by_rank, first = _layout(parts, owners)
    pairs = sorted(perm)
    recv = _swap({q: [parts[s] for s, t in pairs if owners[s] == me and owners[t] == q] for q in by_rank}, first)
    got = {}
    for p, tensors in recv.items():
        got.update(zip([t for s, t in pairs if owners[s] == p and owners[t] == me], tensors))
    out = []
    for k in range(d):
        if parts[k] is None:
            out.append(None)
        elif k in got:
            out.append(_to(got[k], parts[k].device))
        elif k in dsts:
            out.append(parts[srcs[dsts.index(k)]].to(parts[k].device))
        else:
            out.append(torch.zeros_like(parts[k]))
    return tuple(out)
