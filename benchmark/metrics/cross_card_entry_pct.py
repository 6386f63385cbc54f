"""The share (%) of the entries that the ingest routed whose owner is
another card: 100 x the program's counters ``shard.crossed_entries`` over
``shard.routed_entries``. Every call routes the same blocks, so the share
does not depend on how many calls the counters saw. Nothing where the
program has no such counters."""


def read(trace, shapes):
    try:
        from sparsebase_tpu_torch.utils.tracing import counters
    except ImportError:  # a program without the counters
        return None
    seen = counters()
    routed = seen.get("shard.routed_entries", 0)
    if not routed:
        return None
    return 100.0 * seen.get("shard.crossed_entries", 0) / routed
