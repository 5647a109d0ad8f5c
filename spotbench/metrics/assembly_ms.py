"""Batch assembly (``RequestBatch.from_requests``: the filter masks and
request arrays on the host), host milliseconds a serve call."""
UNIT = "ms"


def read(run):
    spans = run.spans.get("assembly")
    return sum(spans) / run.n_calls * 1e3 if spans else None
