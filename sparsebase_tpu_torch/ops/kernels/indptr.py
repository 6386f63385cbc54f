"""CSR ``indptr`` from row-sorted COO rows: the wrapper over kernel K3 and
its plain version.

K3 (``csrc/indptr.cu``) replaces the streaming-indptr Pallas kernel
(``tools/pallas_attempts.py::build_stream_indptr``) and takes over the
port's ``torch.searchsorted`` formulation, the counterpart of the JAX
``indptr_from_sorted_rows`` / ``indptr_from_sorted_rows_blocked``
(``sparsebase_tpu/convert/kernels.py:44-148``). CPU tensors take the plain
version; CUDA tensors launch the kernel, or the wrapper raises. The kernel
reads int32 row ids: any other integer type is narrowed before the launch
by a checked cast, which raises on an id past int32.
"""

from __future__ import annotations

import ctypes

import torch

from ..._build import Kernel
from ...utils.exceptions import TypeMismatchError
from ._args import kernel_ids

_K3 = Kernel(
    "indptr",
    "sb_indptr_from_sorted_rows",
    [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p],
)


def indptr_plain(row: torch.Tensor, nrows: int) -> torch.Tensor:
    """``indptr[r]`` = first position whose row is ``>= r``: one
    ``searchsorted`` of the row boundaries (int64 offsets)."""
    bounds = torch.arange(nrows + 1, dtype=row.dtype, device=row.device)
    return torch.searchsorted(row, bounds)


def indptr_from_sorted_rows(row: torch.Tensor, nrows: int) -> torch.Tensor:
    """CSR ``indptr`` (int64, ``(nrows+1,)``) of a row-sorted COO row array;
    empty rows, leading, interior and trailing, take the next row's start."""
    if row.device.type == "cpu":
        return indptr_plain(row, nrows)
    if row.device.type != "cuda":
        raise TypeMismatchError(f"indptr: rows on {row.device}; need the CPU or a CUDA device")
    if row.dim() != 1:
        raise TypeMismatchError(f"indptr: needs a 1-D row array, got {row.dim()} dims")
    row = kernel_ids(row, "indptr rows")
    indptr = torch.empty((nrows + 1,), dtype=torch.int64, device=row.device)
    with torch.cuda.device(row.device):
        stream = torch.cuda.current_stream(row.device).cuda_stream
        _K3.launch(row.data_ptr(), row.numel(), nrows, indptr.data_ptr(), stream)
    return indptr
