"""ELL (row-padded) format.

Counterpart of ``sparsebase_tpu/formats/ell.py``. Layout: ``cols[i, j]`` is
the j-th column id of row i (int32, pad slots 0), ``vals[i, j]`` its value
(pad 0; ``None`` for a pattern matrix), ``lens[i]`` the row's true length
(int32). A row longer than the width cannot be held: ``csr_to_ell`` sizes
the width to the largest degree. A row permutation is one gather of whole
rows; the per-row column sort is one stable sort along the rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .base import Format, register_format

_PAD_KEY = torch.iinfo(torch.int32).max  # sorts past every real column


@register_format
@dataclasses.dataclass(frozen=True)
class ELL(Format):
    """Order-2 row-padded sparse matrix (ELLPACK)."""

    cols: torch.Tensor  # (n, W) int32 column ids; pad slots 0
    vals: Optional[torch.Tensor]  # (n, W) values, or None (pattern)
    lens: torch.Tensor  # (n,) int32 true row lengths
    _shape: Tuple[int, int] = (0, 0)

    order = 2

    @staticmethod
    def new(cols, vals, lens, shape) -> "ELL":
        return ELL(cols, vals, lens, (int(shape[0]), int(shape[1])))

    @property
    def shape(self) -> Tuple[int, int]:
        return self._shape

    @property
    def width(self) -> int:
        return int(self.cols.shape[1])

    @property
    def nnz(self) -> int:
        """Stored entries: reads ``lens`` back to the host."""
        return int(self.lens.sum())

    @property
    def nrows(self) -> int:
        return self._shape[0]

    @property
    def ncols(self) -> int:
        return self._shape[1]

    @property
    def value_dtype(self):
        return None if self.vals is None else self.vals.dtype

    def valid_mask(self) -> torch.Tensor:
        """(n, W) bool: which slots hold real entries."""
        slots = torch.arange(self.width, dtype=self.lens.dtype, device=self.lens.device)
        return slots[None, :] < self.lens[:, None]

    def permute_rows(self, order: torch.Tensor) -> "ELL":
        """Rows relaid so that new row ``order[i]`` is old row ``i`` (the
        package's inverse-permutation convention): one gather of whole rows."""
        n = self.nrows
        perm = torch.empty((n,), dtype=torch.int64, device=self.cols.device)
        perm[order.long()] = torch.arange(n, device=self.cols.device)  # perm[new] = old
        return dataclasses.replace(
            self,
            cols=self.cols[perm],
            vals=None if self.vals is None else self.vals[perm],
            lens=self.lens[perm],
        )

    def sort_rows(self) -> "ELL":
        """Sort each row's columns ascending, carrying the values; pad slots
        sort past every real column and are zeroed again. The sort is stable:
        equal columns keep their order."""
        mask = self.valid_mask()
        keyed = torch.where(mask, self.cols, torch.full_like(self.cols, _PAD_KEY))
        cols, order = torch.sort(keyed, dim=1, stable=True)
        cols = torch.where(mask, cols, torch.zeros_like(cols))
        vals = None
        if self.vals is not None:
            vals = torch.where(mask, torch.gather(self.vals, 1, order), torch.zeros_like(self.vals))
        return dataclasses.replace(self, cols=cols, vals=vals)

    def __repr__(self) -> str:
        return f"ELL(shape={self._shape}, width={self.width}, context={self.context!r})"
