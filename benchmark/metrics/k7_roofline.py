"""K7's share of its roofline (%): ``bound("label_prop")`` of one round at
the input's shape and ``k`` parts over the device time of K7's kernels per
round."""

from benchmark.core.bounds import roofline_pct


def read(trace, shapes):
    per_round = trace.kernel_s("K7") / (trace.calls * shapes["rounds"])
    return roofline_pct("label_prop", per_round, n=shapes["n"], nnz=shapes["nnz"], k=shapes["k"])
