"""The device's idle time that the program owns, as a share (%) of the
traced window: the holes in the device's work that fall inside the host
intervals of the program's ``sbtorch:`` spans (Python between launches,
the program's host reads), less the time in them that the profiler's own
``Activity Buffer Request`` holds the host. The rest of
``device_idle_pct`` is the harness's: its synchronise after each call, its
loop, and the window's edges. Nothing where the program opened no span."""

from benchmark.core.trace import idle_gaps

PROFILER_OP = "Activity Buffer Request"


def _merged(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _overlap(a, b):
    """The intervals common to two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append([lo, hi])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def read(trace, shapes):
    program = _merged((h[0], h[1]) for h in trace.host_ops if h[2].startswith("sbtorch:"))
    if not program or not trace.kernels or trace.window_s <= 0:
        return None
    profiler = _merged((h[0], h[1]) for h in trace.host_ops if h[2] == PROFILER_OP)
    owned = _overlap(_merged(idle_gaps(trace)), program)
    idle_us = sum(hi - lo for lo, hi in owned) - sum(hi - lo for lo, hi in _overlap(owned, profiler))
    return 100.0 * idle_us / (trace.window_s * 1e6)
