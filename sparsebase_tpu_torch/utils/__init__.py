"""Utilities: exceptions, logging, dtype checks (reference: src/sparsebase/utils/)."""

from .exceptions import (
    AttemptToReset,
    ConversionError,
    DirectExecutionNotAvailableError,
    FeatureError,
    FunctionNotFoundError,
    InvalidDataMember,
    PartitionError,
    ReaderError,
    ReorderError,
    SparseBaseError,
    TypeMismatchError,
    WriterError,
)
from .logger import LOG_LVL_INFO, LOG_LVL_NONE, LOG_LVL_WARNING, Logger, LogLevel
from .typing import (
    FLOAT_DTYPES,
    ID_DTYPES,
    NNZ_DTYPES,
    VALUE_DTYPES,
    can_dtype_fit,
    convert_array_dtype,
    index_dtype_for,
)

__all__ = [
    "SparseBaseError",
    "TypeMismatchError",
    "ConversionError",
    "FunctionNotFoundError",
    "DirectExecutionNotAvailableError",
    "ReaderError",
    "WriterError",
    "ReorderError",
    "FeatureError",
    "PartitionError",
    "AttemptToReset",
    "InvalidDataMember",
    "Logger",
    "LogLevel",
    "LOG_LVL_INFO",
    "LOG_LVL_WARNING",
    "LOG_LVL_NONE",
    "can_dtype_fit",
    "convert_array_dtype",
    "index_dtype_for",
    "ID_DTYPES",
    "NNZ_DTYPES",
    "VALUE_DTYPES",
    "FLOAT_DTYPES",
]
