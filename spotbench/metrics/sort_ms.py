"""Device milliseconds a serve call of what ``core.pool._sort_masked``
launches: Algorithm 1's stable sort and its gathers."""
UNIT = "ms"


def read(run):
    if run.trace is None or not run.trace.device_s.get("sort"):
        return None
    return run.trace.device_s["sort"] / run.n_calls * 1e3
