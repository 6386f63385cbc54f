"""The share (%) of the entries that K4's CUDA route relocated which lay in
rows over its block tier: 100 x the program's counters
``relocate.long_row_entries`` over ``relocate.entries``. Every call of a run
relocates the same matrix, so the share does not depend on how many calls
the counters saw. Nothing where the program has no such counters."""


def read(trace, shapes):
    try:
        from sparsebase_tpu_torch.utils.tracing import counters
    except ImportError:  # a program without the counters
        return None
    seen = counters()
    entries = seen.get("relocate.entries", 0)
    if not entries:
        return None
    return 100.0 * seen.get("relocate.long_row_entries", 0) / entries
