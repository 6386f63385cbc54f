"""Device ms per call of the program's span ``sbtorch:shard:ingest``
(``ShardedCSR.from_coo_blocks``: the owner route, the cross-card exchange
of the entries, each owner's K5 sorts and K3 offsets), read over the
span's device ranges and those of the spans opened inside it
(``permute_roofline.stage_s``), on every card at once: the time in which
some card works inside it. Nothing where the span never reached a card."""

from benchmark.metrics.permute_roofline import stage_s

SPAN = "sbtorch:shard:ingest"


def read(trace, shapes):
    seconds = stage_s(trace, SPAN)
    return None if seconds is None else 1e3 * seconds / trace.calls
