"""CSR row SpMV: the wrapper over kernel K2 and its plain version.

K2 (``csrc/csr_spmv.cu``) takes over the main path's SpMV, which the JAX
package wrote as an XLA cumsum boundary difference
(``sparsebase_tpu/models/pipelines.py:59-61,189-198``). It splits the
entries into tiles of ``TILE``; a row that crosses a tile edge leaves its
parts in a scratch buffer that this wrapper allocates, and the same C call
adds them in tile order, so ``y`` is the same bit for bit on every run.
CPU tensors take the plain version; CUDA tensors launch the kernel, or the
wrapper raises.

The kernel computes in float32 on int64 offsets and int32 ids. On the card
the wrapper converts before the launch: values of any other type (bf16,
f16, f64, integers) are cast to float32, as the plain version casts them to
``x.dtype``; offsets are widened and ids narrowed by a checked cast. ``x``
itself must be float32 there: the result has ``x``'s type, and the card
path has no other.
"""

from __future__ import annotations

import ctypes

import torch

from ..._build import Kernel
from ...formats.csr import CSR
from ...utils.exceptions import TypeMismatchError
from ._args import kernel_ids, kernel_offsets

TILE = 2048  # entries per block (kTile in csrc/csr_spmv.cu)

_K2 = Kernel(
    "csr_spmv",
    "sb_csr_spmv",
    [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3 + [ctypes.c_void_p] * 3,
)


def tile_count(nnz: int) -> int:
    """Tiles of K2 over ``nnz`` entries; one when there are none, which
    still writes the zero rows."""
    return max(1, -(-nnz // TILE))


def csr_spmv_plain(csr: CSR, x: torch.Tensor) -> torch.Tensor:
    """Per-row sums by ``index_add_`` in ``x.dtype`` (the oracle of K2;
    on a CUDA device its additions land in no fixed order)."""
    prod = x[csr.indices]
    if csr.vals is not None:
        prod = csr.vals.to(x.dtype) * prod
    y = torch.zeros((csr.nrows,), dtype=x.dtype, device=x.device)
    return y.index_add_(0, csr.row_of_nnz(), prod)


def check_real(csr: CSR, x: torch.Tensor) -> None:
    """Raises ``TypeMismatchError`` for a complex matrix or ``x``: the SpMVs
    sum real products and never drop an imaginary part quietly."""
    if x.dtype.is_complex or (csr.vals is not None and csr.vals.dtype.is_complex):
        raise TypeMismatchError("the CSR SpMV computes real sums; a complex matrix or x is not cast to real")


def csr_spmv(csr: CSR, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x, one exact-order sum per row."""
    if x.shape != (csr.ncols,):
        raise ValueError(f"x has shape {tuple(x.shape)}, expected ({csr.ncols},)")
    check_real(csr, x)
    tensors = [t for t in (csr.indptr, csr.indices, csr.vals, x) if t is not None]
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return csr_spmv_plain(csr, x)
    if len(devices) != 1 or x.device.type != "cuda":
        raise TypeMismatchError(f"csr_spmv: tensors on {sorted(map(str, devices))}; need one CUDA device")
    if x.dtype != torch.float32:
        raise TypeMismatchError(f"csr_spmv: x is {x.dtype}; the card path computes in float32 and takes a "
                                "float32 x (values of any type are cast to it)")
    if csr.indptr.shape != (csr.nrows + 1,):
        raise ValueError("csr_spmv: indptr length is not nrows + 1")
    indptr = kernel_offsets(csr.indptr, "csr_spmv indptr")
    indices = kernel_ids(csr.indices, "csr_spmv column ids")
    x = x.contiguous()
    vals = None if csr.vals is None else csr.vals.to(torch.float32).contiguous()
    y = torch.empty((csr.nrows,), dtype=torch.float32, device=x.device)
    if csr.nrows == 0:
        return y
    ntiles = tile_count(csr.nnz)
    first = torch.empty((ntiles + 1,), dtype=torch.int64, device=x.device)  # each tile's first row
    partial = torch.empty((2 * ntiles,), dtype=torch.float32, device=x.device)  # crossing rows' parts
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _K2.launch(
            indptr.data_ptr(), indices.data_ptr(),
            None if vals is None else vals.data_ptr(),
            x.data_ptr(), y.data_ptr(), csr.nrows, csr.nnz, ntiles,
            first.data_ptr(), partial.data_ptr(), stream,
        )
    return y
