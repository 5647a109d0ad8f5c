"""Device milliseconds of the device-to-host copies a serve call, from the
profiler's trace."""
UNIT = "ms"


def read(run):
    if run.trace is None or run.trace.d2h_s <= 0:
        return None
    return run.trace.d2h_s / run.n_calls * 1e3
