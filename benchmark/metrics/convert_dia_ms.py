"""Device ms per call of the operations that ran inside the benchmark's span
``bench:convert:CSR->DIA`` around ``csr.convert(DIA)``, as the device ran
it; nothing where the span never reached the device."""


def read(trace, shapes):
    seconds = trace.inside_s("bench:convert:CSR->DIA")
    return None if seconds is None else 1e3 * seconds / trace.calls
