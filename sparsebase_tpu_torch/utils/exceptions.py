"""Exception hierarchy for sparsebase_tpu_torch.

Mirrors the capability surface of the reference exception set
(reference: src/sparsebase/utils/exception.h:1-201) with idiomatic Python
exceptions. Where the reference throws on bad template casts we raise
``TypeError`` subclasses; where it throws on missing dispatch functions we
raise ``FunctionNotFoundError``.
"""

from __future__ import annotations


class SparseBaseError(Exception):
    """Root of all sparsebase_tpu_torch errors."""


class TypeMismatchError(SparseBaseError, TypeError):
    """Raised on an invalid format downcast or unsafe dtype conversion.

    Reference analogue: ``utils::TypeException`` (utils/exception.h).
    """


class ConversionError(SparseBaseError):
    """No conversion path exists between two formats/placements.

    Reference analogue: ``utils::ConversionException``.
    """

    def __init__(self, frm: str, to: str):
        self.frm, self.to = frm, to
        super().__init__(f"Can not convert type {frm} to {to}")


class FunctionNotFoundError(SparseBaseError):
    """Dispatch failure: no registered implementation matches the inputs.

    Reference analogue: ``utils::FunctionNotFoundException``.
    """


class DirectExecutionNotAvailableError(FunctionNotFoundError):
    """Exact-match dispatch failed and input conversion was disabled.

    Reference analogue: ``utils::DirectExecutionNotAvailableException``
    (utils/exception.h; thrown from function_matcher_mixin.h:335-416).
    """

    def __init__(self, key, available):
        self.key = tuple(key)
        self.available = [tuple(k) for k in available]
        names = ", ".join("(" + ", ".join(t.__name__ for t in k) + ")" for k in self.available)
        key_name = "(" + ", ".join(t.__name__ for t in self.key) + ")"
        super().__init__(
            f"No direct implementation for input types {key_name}; available keys: [{names}]"
        )


class ReaderError(SparseBaseError):
    """Malformed input file or unsupported file feature.

    Reference analogue: ``utils::ReaderException``.
    """


class WriterError(SparseBaseError):
    """Cannot serialize the given object to the requested file format.

    Reference analogue: ``utils::WriterException``.
    """


class ReorderError(SparseBaseError):
    """Reordering algorithm failure (bad parameters, unsupported input).

    Reference analogue: ``utils::ReorderException``.
    """


class FeatureError(SparseBaseError):
    """Feature-extraction failure.

    Reference analogue: ``utils::FeatureException``.
    """


class PartitionError(SparseBaseError):
    """Partitioner failure (bad parameters, unsupported input)."""


class AttemptToReset(SparseBaseError):
    """A write-once attribute was assigned twice.

    Reference analogue: ``utils::AttemptToReset`` (for OnceSettable,
    utils/utils.h:151-171).
    """

    def __init__(self, name: str):
        super().__init__(f"Attempting to reset write-once attribute {name!r}")


class InvalidDataMember(SparseBaseError):
    """Requested a data member a format does not carry (e.g. values of a
    pattern-only matrix).

    Reference analogue: ``utils::InvalidDataMember``.
    """
