"""Device ms per call of the program's span ``sbtorch:halo:exchange``:
every ``all_to_all`` of halo lists (``with_halo``) and of halo values (one
an SpMV), read as ``shard_ingest_ms`` reads its span. Nothing where the
span never reached a card."""

from benchmark.metrics.permute_roofline import stage_s

SPAN = "sbtorch:halo:exchange"


def read(trace, shapes):
    seconds = stage_s(trace, SPAN)
    return None if seconds is None else 1e3 * seconds / trace.calls
