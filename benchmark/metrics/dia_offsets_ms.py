"""Device ms per call of the CSR to DIA conversion's first stage, the
program's host span ``sbtorch:csr_to_dia:offsets``: each entry's row, its
column less its row, and the ``unique`` of those differences (a sort, and
the host read that sizes the band).

The conversion's spans are host ranges: its kernels stay in the device range
of the caller's span around it (``bench:convert:CSR->DIA``). The stage ends
in that host read, so its device work is done when the host enters
``sbtorch:csr_to_dia:fill``, and the second stage's begins after: the reader
takes the device time of the innermost device range around that moment,
before it. Nothing where the span never ran inside a device range."""

from benchmark.core.trace import union_us

SPLIT = "sbtorch:csr_to_dia:fill"


def read(trace, shapes):
    lo_w, hi_w = trace.window
    total, found = 0.0, False
    for split, _, _ in (h for h in trace.host_ops if h[2] == SPLIT):
        around = [a for a in trace.annotations if a[0] <= split <= a[1]]
        if around:
            lo = min(around, key=lambda a: a[1] - a[0])[0]
            total += union_us(trace.kernels, max(lo, lo_w), min(split, hi_w))
            found = True
    return 1e3 * total / 1e6 / trace.calls if found else None
