"""The symmetric permutation's share of its roofline (%): the bound of
``k4_roofline`` (``bound("relocate_csr")`` at the input's n and entries,
float32 values, one order of n entries) over the device time per call of
the program's stage ``sbtorch:stage:permute``, K4 with its casts and its
long-row route.

The profiler gives a kernel's device range to the innermost span open when
it was launched, so the stage's time is read over the device ranges of its
own span and of every ``sbtorch:`` span that the host opened inside it
(``sbtorch:relocate:long_rows``). Nothing where the stage never reached the
device."""

from benchmark.core.bounds import roofline_pct
from benchmark.core.trace import union_us

SPAN = "sbtorch:stage:permute"


def _merged(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def stage_s(trace, span):
    """Device seconds of the operations in the device ranges of ``span`` and
    of the spans opened inside it on the host; None where there are none."""
    outer = [h for h in trace.host_ops if h[2] == span]
    nested = {span} | {h[2] for h in trace.host_ops
                        if h[2].startswith("sbtorch:") and any(o[0] <= h[0] and h[1] <= o[1] for o in outer)}
    ranges = [(a[0], a[1]) for a in trace.annotations if a[2] in nested]
    if not ranges:
        return None
    lo, hi = trace.window
    return sum(union_us(trace.kernels, max(a, lo), min(b, hi)) for a, b in _merged(ranges)) / 1e6


def read(trace, shapes):
    seconds = stage_s(trace, SPAN)
    if seconds is None:
        return None
    return roofline_pct("relocate_csr", seconds / trace.calls, n=shapes["n"], nnz=shapes["nnz"],
                        order_entries=shapes["n"], value_bytes=4)
