"""The 90th percentile of every answered request's time from its
submission to its result (host clock); the requests of one call share
its time."""
import numpy as np

UNIT = "ms"


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(run.latencies_s, 90)) * 1e3
