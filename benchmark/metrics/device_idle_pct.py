"""The device's idle share of the traced window (%): 100 x (1 - the union of
the device operations' intervals over the window's wall time)."""


def read(trace, shapes):
    if trace.window_s <= 0 or not trace.kernels:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
