"""K2's share of its roofline (%): ``bound("csr_spmv")`` of the call's SpMV
at the input's shape over the device time of K2's kernels per call."""

from benchmark.core.bounds import roofline_pct


def read(trace, shapes):
    return roofline_pct("csr_spmv", trace.kernel_s("K2") / trace.calls, n=shapes["n"], ncols=shapes["ncols"], nnz=shapes["nnz"])
