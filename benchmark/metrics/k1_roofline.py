"""K1's share of its roofline (%): ``bound("banded_spmv")`` of one SpMV over
the float32 band (diagonals x n) over the device time of K1's kernels per
SpMV."""

from benchmark.core.bounds import roofline_pct


def read(trace, shapes):
    per_spmv = trace.kernel_s("K1") / (trace.calls * shapes["iterations"])
    return roofline_pct("banded_spmv", per_spmv, ndiag=shapes["ndiag"], n=shapes["n"], m=shapes["m"], band_bytes=4)
