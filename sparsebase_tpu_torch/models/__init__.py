"""End-to-end pipelines."""

from .pipelines import (
    partition_pipeline,
    preprocess_pipeline,
    preprocess_pipeline_donating,
    rcm_pipeline,
    spmv,
    spmv_csr,
    spmv_ell,
)

__all__ = [
    "partition_pipeline",
    "preprocess_pipeline",
    "preprocess_pipeline_donating",
    "rcm_pipeline",
    "spmv",
    "spmv_csr",
    "spmv_ell",
]
