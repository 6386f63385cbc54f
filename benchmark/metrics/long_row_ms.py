"""Device ms per call of the operations inside the program's span
``sbtorch:relocate:long_rows``: K4's route for the rows over its block tier
(torch gathers and scatters, and a K5 sort of 64-bit keys), none of it K4's
own kernels. Nothing where the span never reached the device."""


def read(trace, shapes):
    seconds = trace.inside_s("sbtorch:relocate:long_rows")
    return None if seconds is None else 1e3 * seconds / trace.calls
