"""Where a reader puts what it reads.

A reader is an entry point, so it places its format on the card unless the
caller asks for the CPU (``device="cpu"``). Asked for CUDA where there is
no card, it raises rather than carry on on the CPU. Before the copy, the
ids parsed on the host are narrowed to their index type, with a check.
"""

from __future__ import annotations

import torch

from ..utils.exceptions import ReaderError
from ..utils.typing import can_dtype_fit

DEFAULT_DEVICE = "cuda"


def target_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the reader was asked for {dev} and torch.cuda.is_available() is false; pass device='cpu' to read "
            "onto the host"
        )
    return dev


def narrow_ids(ids: torch.Tensor, id_dtype: torch.dtype) -> torch.Tensor:
    """``ids`` cast to ``id_dtype``; an id that does not fit (or a
    fractional one) raises ``ReaderError`` instead of wrapping into the
    file's shape."""
    if not can_dtype_fit(id_dtype, ids):
        raise ReaderError(f"the file holds ids that do not fit {id_dtype}")
    return ids.to(id_dtype)
