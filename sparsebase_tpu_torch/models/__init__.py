"""End-to-end pipelines."""

from .pipelines import preprocess_pipeline, rcm_pipeline, spmv, spmv_csr, spmv_ell

__all__ = ["preprocess_pipeline", "rcm_pipeline", "spmv", "spmv_csr", "spmv_ell"]
