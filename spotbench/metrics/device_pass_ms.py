"""The engine's device pass (``RecommendationEngine.batch_arrays``, through
its copies back to the host), host milliseconds a serve call."""
UNIT = "ms"


def read(run):
    spans = run.spans.get("device_pass")
    return sum(spans) / run.n_calls * 1e3 if spans else None
