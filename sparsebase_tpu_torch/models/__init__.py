"""End-to-end pipelines."""

from .pipelines import preprocess_pipeline, preprocess_pipeline_donating, rcm_pipeline, spmv, spmv_csr, spmv_ell

__all__ = ["preprocess_pipeline", "preprocess_pipeline_donating", "rcm_pipeline", "spmv", "spmv_csr", "spmv_ell"]
