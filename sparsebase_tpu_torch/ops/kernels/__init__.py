"""Hand-written CUDA kernels for Hopper, each beside its plain version."""

from .banded_spmv import banded_spmv, dia_spmv_plain, tile_band, untile_band
from .common_neighbors import common_neighbors, common_neighbors_plain
from .csr_spmv import csr_spmv, csr_spmv_plain
from .indptr import indptr_from_sorted_rows, indptr_plain
from .label_prop import label_prop_round, label_prop_round_plain
from .radix import plan_passes, radix_argsort, radix_argsort_plain, radix_passes_plain, radix_rank, radix_rank_plain
from .relocate import relocate_csr, relocate_csr_plain

__all__ = [
    "banded_spmv",
    "dia_spmv_plain",
    "tile_band",
    "untile_band",
    "common_neighbors",
    "common_neighbors_plain",
    "csr_spmv",
    "csr_spmv_plain",
    "indptr_from_sorted_rows",
    "indptr_plain",
    "label_prop_round",
    "label_prop_round_plain",
    "plan_passes",
    "radix_argsort",
    "radix_argsort_plain",
    "radix_passes_plain",
    "radix_rank",
    "radix_rank_plain",
    "relocate_csr",
    "relocate_csr_plain",
]
