"""The exchanges' share (%) of the cards' links: the bytes that
``all_to_all`` copied from one card to another in a call (the program's
counter ``collectives.card_bytes``) over what the cards' NVLink could move
in the device time of the spans that hold every such copy,
``sbtorch:shard:exchange`` and ``sbtorch:halo:exchange``: that time x the
cards x 450 GB/s, an H100's NVLink rate each way.

The counters add up over the process's calls, and every call routes each
of the input's entries once: the calls they saw are
``shard.routed_entries`` over the entries. Nothing where the program has
no such counters or spans."""

from benchmark.metrics.permute_roofline import stage_s

LINK_BYTES_PER_S = 450e9  # NVLink 4 on an H100 SXM: 900 GB/s both ways
SPANS = ("sbtorch:shard:exchange", "sbtorch:halo:exchange")


def read(trace, shapes):
    try:
        from sparsebase_tpu_torch.utils.tracing import counters
    except ImportError:  # a program without the counters
        return None
    seen = counters()
    routed, moved = seen.get("shard.routed_entries", 0), seen.get("collectives.card_bytes", 0)
    spans = [stage_s(trace, span) for span in SPANS]
    if not routed or not moved or None in spans:
        return None
    bytes_per_call = moved * shapes["nnz"] / routed
    seconds_per_call = sum(spans) / trace.calls
    return 100.0 * bytes_per_call / (seconds_per_call * shapes["cards"] * LINK_BYTES_PER_S)
