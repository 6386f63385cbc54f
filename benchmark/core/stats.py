"""The measured window, and the arithmetic of the end-to-end metrics."""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class Window:
    """One measured window: every call's seconds, from its start to the
    synchronise that ends it, and the window's wall seconds, from the first
    call's start to the last call's end."""

    call_s: List[float]
    wall_s: float
    work_per_call: int  # the input's entries
    setup_s: float
    peak_bytes: Optional[int]  # max_memory_allocated over the window; None without a card
    base_bytes: Optional[int]  # allocated just before the first timed call: the inputs


def throughput(work_per_call: int, calls: int, wall_s: float) -> float:
    """All the work of the window over all its time."""
    return work_per_call * calls / wall_s
