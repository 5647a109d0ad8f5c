"""Requests answered per second over the whole window (host clock): every
answer of every call over the seconds from the first submission to the
last answer."""
UNIT = "req/s"


def read(run):
    return run.answered / run.window_s if run.window_s > 0 else None
