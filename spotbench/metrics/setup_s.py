"""Seconds from the process's start to the first timed call: generating
the inputs, staging the archive, building or loading the
kernels and the warm-up calls."""
UNIT = "s"


def read(run):
    return run.setup_s
