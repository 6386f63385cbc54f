"""Device ms per call of the program's span ``sbtorch:shard:halo``
(``ShardedCSR.with_halo``: each shard's K5 sort of its columns, its request
lists and halo map, and their exchange), read as ``shard_ingest_ms`` reads
its span. Nothing where the span never reached a card."""

from benchmark.metrics.permute_roofline import stage_s

SPAN = "sbtorch:shard:halo"


def read(trace, shapes):
    seconds = stage_s(trace, SPAN)
    return None if seconds is None else 1e3 * seconds / trace.calls
