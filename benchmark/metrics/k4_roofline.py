"""K4's share of its roofline (%): the least time of the call's symmetric
permutation (``bound("relocate_csr")`` at the input's n and entries, float32
values, one order of n entries) over the device time of K4's kernels
(``kernels.json``) per call. The long-row route's torch ops and K5 sort are
not K4's kernels and are not in the time."""

from benchmark.core.bounds import roofline_pct


def read(trace, shapes):
    return roofline_pct("relocate_csr", trace.kernel_s("K4") / trace.calls, n=shapes["n"], nnz=shapes["nnz"],
                        order_entries=shapes["n"], value_bytes=4)
