"""The results tail (``RecommendationEngine._build_recommendations``: the
max_types split, hourly costs, diagnostics), host milliseconds a serve
call."""
UNIT = "ms"


def read(run):
    spans = run.spans.get("results")
    return sum(spans) / run.n_calls * 1e3 if spans else None
