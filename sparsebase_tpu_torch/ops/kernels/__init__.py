"""Hand-written CUDA kernels for Hopper, each beside its plain version."""

from .banded_spmv import banded_spmv, dia_spmv_plain, tile_band, untile_band
from .csr_spmv import csr_spmv, csr_spmv_plain

__all__ = [
    "banded_spmv",
    "dia_spmv_plain",
    "tile_band",
    "untile_band",
    "csr_spmv",
    "csr_spmv_plain",
]
