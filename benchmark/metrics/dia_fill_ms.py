"""Device ms per call of the CSR to DIA conversion's second stage, the
program's host span ``sbtorch:csr_to_dia:fill``: each entry's diagonal
(``searchsorted``), the zeroed band and the accumulating ``index_put_``.

The conversion's spans are host ranges: its kernels stay in the device range
of the caller's span around it (``bench:convert:CSR->DIA``). The first stage
ends in the host read that sizes the band, so the device is done with it
when the host enters this span: the reader takes the device time of the
innermost device range around that moment, after it. Nothing where the span
never ran inside a device range."""

from benchmark.core.trace import union_us

SPAN = "sbtorch:csr_to_dia:fill"


def read(trace, shapes):
    lo_w, hi_w = trace.window
    total, found = 0.0, False
    for split, _, _ in (h for h in trace.host_ops if h[2] == SPAN):
        around = [a for a in trace.annotations if a[0] <= split <= a[1]]
        if around:
            hi = min(around, key=lambda a: a[1] - a[0])[1]
            total += union_us(trace.kernels, max(split, lo_w), min(hi, hi_w))
            found = True
    return 1e3 * total / 1e6 / trace.calls if found else None
