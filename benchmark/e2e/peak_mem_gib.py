"""Device memory a call takes at its peak: ``max_memory_allocated`` over the
window, less what was allocated just before the first timed call (the
inputs), in GiB. None on a run without a card."""


def read(window):
    if window.peak_bytes is None:
        return None
    return (window.peak_bytes - window.base_bytes) / 2**30
