"""Bucketed padding: a CSR padded up to bucket sizes, with its true sizes.

Counterpart of ``sparsebase_tpu/formats/padded.py``. Padding is inert for
value ops (SpMV and the like): pad rows are empty except the last, which
holds the pad entries as (column 0, value 0). Structural ops must look at
the unpadded matrix: :meth:`PaddedCSR.unpad` gives the input back exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..context import Context
from .base import Format, register_format
from .csr import CSR


def next_bucket(x: int, policy: str = "pow2") -> int:
    """Smallest bucket boundary ``>= x``. ``"pow2"`` doubles; ``"pow2_half"``
    adds the midpoints (1.0x and 1.5x of each power) for tighter fits."""
    if x <= 1:
        return 1
    p = 1 << (int(x - 1).bit_length())
    if policy == "pow2":
        return p
    if policy == "pow2_half":
        cand = (p * 3) // 4  # between p/2 and p
        return cand if cand >= x else p
    raise ValueError(f"unknown bucket policy {policy!r}")


@register_format
@dataclasses.dataclass(frozen=True)
class PaddedCSR(Format):
    """A CSR padded to bucket sizes, and the original dimensions and count."""

    csr: CSR
    _orig_shape: Tuple[int, int] = (0, 0)
    _orig_nnz: int = 0

    order = 2

    def _tensors(self):
        return self.csr._tensors()

    def to(self, context: Context) -> "PaddedCSR":
        return dataclasses.replace(self, csr=self.csr.to(context))

    @property
    def shape(self) -> Tuple[int, int]:
        return self._orig_shape

    @property
    def padded_shape(self) -> Tuple[int, int]:
        return self.csr.shape

    @property
    def nnz(self) -> int:
        return self._orig_nnz

    @property
    def padded_nnz(self) -> int:
        return self.csr.nnz

    def unpad(self) -> CSR:
        n, m = self._orig_shape
        vals = None if self.csr.vals is None else self.csr.vals[: self._orig_nnz]
        return CSR(self.csr.indptr[: n + 1], self.csr.indices[: self._orig_nnz], vals, (n, m))

    def __repr__(self) -> str:
        return (
            f"PaddedCSR(orig={self._orig_shape}/{self._orig_nnz}nnz, "
            f"padded={self.padded_shape}/{self.padded_nnz}nnz)"
        )


def pad_csr(
    csr: CSR,
    row_bucket: Optional[int] = None,
    nnz_bucket: Optional[int] = None,
    policy: str = "pow2",
) -> PaddedCSR:
    """Pad a CSR to bucket boundaries (given sizes, or ``policy``).

    The pad entries become (column 0, value 0) entries of the last pad row,
    so value ops are unchanged; where entries must be padded and no row is,
    one row is added to hold them. A pattern matrix gains explicit values
    (ones for its entries, zeros for the padding)."""
    n, m = csr.shape
    nnz = csr.nnz
    rb = row_bucket if row_bucket is not None else next_bucket(n, policy)
    nb = nnz_bucket if nnz_bucket is not None else next_bucket(max(nnz, 1), policy)
    if rb < n or nb < nnz:
        raise ValueError("bucket smaller than matrix")
    if rb == n and nb == nnz and csr.vals is not None:
        return PaddedCSR(csr, (n, m), nnz)

    pad_rows, pad_nnz = rb - n, nb - nnz
    if pad_nnz > 0 and pad_rows == 0:
        pad_rows, rb = 1, rb + 1
    dev = csr.indptr.device
    vals = csr.vals if csr.vals is not None else torch.ones((nnz,), dtype=torch.float32, device=dev)
    last = csr.indptr[-1:]
    tail = torch.cat([last.expand(max(pad_rows - 1, 0)), (last + pad_nnz)[: 1 if pad_rows else 0]])
    indptr = torch.cat([csr.indptr, tail])
    indices = torch.cat([csr.indices, torch.zeros((pad_nnz,), dtype=csr.indices.dtype, device=dev)])
    vals = torch.cat([vals, torch.zeros((pad_nnz,), dtype=vals.dtype, device=dev)])
    return PaddedCSR(CSR(indptr, indices, vals, (rb, m)), (n, m), nnz)
