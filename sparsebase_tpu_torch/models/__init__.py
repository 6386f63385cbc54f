"""End-to-end pipelines."""

from .pipelines import preprocess_pipeline, spmv, spmv_csr

__all__ = ["preprocess_pipeline", "spmv", "spmv_csr"]
