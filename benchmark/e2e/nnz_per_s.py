"""Entries processed per second: the input's entries times the calls
completed in the window, over the window's wall time (host clock)."""

from benchmark.core.stats import throughput


def read(window):
    return throughput(window.work_per_call, len(window.call_s), window.wall_s)
