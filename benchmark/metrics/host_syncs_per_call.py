"""Synchronising CUDA operations a call makes, as
``torch.cuda.set_sync_debug_mode("warn")`` counts them over one call
after the traced window (the count does not change from call to call)."""


def read(trace, shapes):
    return trace.syncs_per_call
