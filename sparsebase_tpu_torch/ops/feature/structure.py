"""Structural features: Bandwidth, Profile, OffDiagBlockNNZ.

Counterpart of ``sparsebase_tpu/ops/feature/structure.py`` (reference:
src/sparsebase/feature/bandwidth.cc:93-112, the largest ``|i - j| + 1`` over
the entries; profile.cc:92-106, ``sum_i (i - min(min_j, i))``;
off_diag_block_nnz.cc:98-116, the entries outside balanced diagonal
blocks). Per-entry tensor expressions and segment reductions in int64, on
the input's device; each result is a 0-d tensor (``Bandwidth`` of an empty
matrix: the int 0).
"""

from __future__ import annotations

import dataclasses

import torch

from ...formats.csr import CSR
from .base import Feature


class Bandwidth(Feature):
    """max(|i - j| + 1) over all entries; 0 for none (bandwidth.cc:93-112)."""

    def __init__(self):
        super().__init__("bandwidth")
        self.register((CSR,), self._impl)

    @staticmethod
    def _impl(formats, params):
        csr: CSR = formats[0]
        if csr.nnz == 0:
            return 0
        row = csr.row_of_nnz().to(torch.int64)
        return ((row - csr.indices.to(torch.int64)).abs() + 1).max()

    def get_bandwidth(self, fmt, context=None, convert_input=True):
        return self.execute(self.params, fmt, context=context, convert_input=convert_input)


class Profile(Feature):
    """sum_i (i - min(min_col(i), i)), the envelope size (profile.cc:92-106)."""

    def __init__(self):
        super().__init__("profile")
        self.register((CSR,), self._impl)

    @staticmethod
    def _impl(formats, params):
        csr: CSR = formats[0]
        dev = csr.indptr.device
        ids = torch.arange(csr.nrows, dtype=torch.int64, device=dev)
        mins = ids.clone()  # j starts at i (profile.cc:98-99)
        mins.scatter_reduce_(0, csr.row_of_nnz().to(torch.int64), csr.indices.to(torch.int64), "amin")
        return (ids - mins).sum()

    def get_profile(self, fmt, context=None, convert_input=True):
        return self.execute(self.params, fmt, context=context, convert_input=convert_input)


@dataclasses.dataclass
class OffDiagBlockNNZParams:
    """blockrowsize h / blockcolsize w: the number of row and column blocks
    (off_diag_block_nnz.cc:98-101)."""

    blockrowsize: int = 2
    blockcolsize: int = 2


def _balanced_starts(total: int, parts: int, device) -> torch.Tensor:
    """Start offsets of ``parts`` balanced chunks of ``total`` (the first
    ``total % parts`` chunks one longer; off_diag_block_nnz.cc:103-106)."""
    p = torch.arange(parts + 1, dtype=torch.int64, device=device)
    return torch.clamp(p * (total // parts) + torch.clamp(p, max=total % parts), max=total)


def _block_of(i: torch.Tensor, total: int, parts: int) -> torch.Tensor:
    """The chunk of ``_balanced_starts(total, parts)`` that holds each of the
    positions ``i`` (all in ``[0, total)``), in closed form: the first
    ``r = total % parts`` chunks hold ``q + 1`` positions, the rest ``q``."""
    q, r = total // parts, total % parts
    head = r * (q + 1)  # positions in the longer chunks; all of them when q == 0
    return torch.where(i < head, i // (q + 1), r + (i - head) // max(q, 1))


class OffDiagBlockNNZ(Feature):
    """nnz outside the p-th diagonal block for every p (off_diag_block_nnz.cc:98-116)."""

    def __init__(self, blockrowsize: int = 2, blockcolsize: int = 2):
        super().__init__("off_diag_block_nnz")
        self.params = OffDiagBlockNNZParams(blockrowsize, blockcolsize)
        self.register((CSR,), self._impl)

    @staticmethod
    def _impl(formats, params: OffDiagBlockNNZParams):
        csr: CSR = formats[0]
        h, w = int(params.blockrowsize), int(params.blockcolsize)
        nrows, ncols = csr.shape
        col_starts = _balanced_starts(ncols, w, csr.indptr.device)
        p = _block_of(csr.row_of_nnz().to(torch.int64), nrows, h)  # block of each row
        if h != w:
            p = torch.clamp(p, max=min(h, w) - 1)
        lo = col_starts[torch.clamp(p, max=w)]
        hi = col_starts[torch.clamp(p + 1, max=w)]
        col = csr.indices.to(torch.int64)
        return ((col < lo) | (col >= hi)).sum()

    def get_off_diag_block_nnz(self, fmt, context=None, convert_input=True):
        return self.execute(self.params, fmt, context=context, convert_input=convert_input)
