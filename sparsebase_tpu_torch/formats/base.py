"""Format base machinery: sparse containers holding torch tensors.

Counterpart of ``sparsebase_tpu/formats/base.py`` (reference
src/sparsebase/format/format.h:86-163). Formats are frozen dataclasses
whose tensor fields carry the data; ``_shape`` is plain metadata. A
pattern matrix (the reference's ``void`` ValueType) has ``vals=None``.
The execution place is read from the tensors' device
(:meth:`Format.context`); :meth:`Format.to` is the H2D/D2H edge.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Type, TypeVar

import torch

from ..context import Context, MeshContext, context_for, context_of
from ..utils.exceptions import TypeMismatchError

T = TypeVar("T", bound="Format")

_REGISTERED_FORMATS: list = []


class Format:
    """Abstract sparse container.

    API parity with the reference ``Format`` (format/format.h:86-163):
    ``get_dimensions`` -> :attr:`shape`, ``get_num_nnz`` -> :attr:`nnz`,
    ``get_context`` -> :attr:`context`, ``AsAbsolute<T>`` -> :meth:`as_format`.
    """

    order: int = -1

    @property
    def shape(self) -> Tuple[int, ...]:
        raise NotImplementedError

    @property
    def nnz(self) -> int:
        raise NotImplementedError

    def _tensors(self):
        return tuple(
            v for v in (getattr(self, f.name) for f in dataclasses.fields(self))
            if isinstance(v, torch.Tensor)
        )

    @property
    def context(self) -> Context:
        tensors = self._tensors()
        return context_of(tensors[0] if tensors else None)

    def as_format(self, cls: Type[T]) -> T:
        """Checked downcast; raises like AsAbsolute<T> (format/format.h:142)."""
        if not isinstance(self, cls):
            raise TypeMismatchError(
                f"Object is of type {type(self).__name__}, not {cls.__name__}"
            )
        return self

    def clone(self: T) -> T:
        """Shallow copy: the tensors are shared, never written in place."""
        return dataclasses.replace(self)

    # -- placement -----------------------------------------------------------
    def to(self: T, context: Context) -> T:
        """Move every tensor field to ``context``'s device. A format of one
        tensor per field is not split over a mesh: ``convert(ShardedCSR,
        MeshContext(...))`` shards a CSR (the sharded formats place their
        shards with ``parallel.shard_rows``)."""
        if isinstance(context, MeshContext):
            raise TypeMismatchError(f"{type(self).__name__} is not a sharded format; convert it to ShardedCSR with "
                                    f"{context!r}")
        device = context.device
        changes = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return dataclasses.replace(self, **changes)

    def to_host(self: T) -> T:
        return self.to(context_for("cpu"))

    def to_device(self: T, device) -> T:
        """Move to ``device`` (explicit: ``torch.device("cuda", i)``)."""
        return self.to(context_for(device))

    # -- conversion ----------------------------------------------------------
    def convert(self, to_cls: Type[T], context: Optional[Context] = None) -> T:
        """Convert through the conversion graph
        (``FormatOrderTwo::Convert<ToType>``, format_order_two.h:36-58)."""
        from ..convert import convert as _convert

        return _convert(self, to_cls, context=context)

    def can_convert(self, to_cls: Type["Format"]) -> bool:
        from ..convert import can_convert as _can

        return _can(type(self), to_cls)


def register_format(cls):
    """Record a format class in the process-wide list of formats."""
    _REGISTERED_FORMATS.append(cls)
    return cls


def registered_formats():
    return tuple(_REGISTERED_FORMATS)
