"""Streaming log-bucketed latency histograms (HDR-style).

The serving observability story needs tail quantiles — p99/p99.9 — over
millions of samples without keeping the samples.  :class:`LatencyHistogram`
is the textbook answer: geometrically-spaced buckets (each ~9% wider than
the last), O(1) ``record``, O(buckets) ``quantile`` with a bounded relative
error equal to the bucket growth factor.  That error model is the right one
for latency: 9% at p99 is noise, while a linear-bucket histogram either
wastes thousands of buckets or clips the tail it exists to measure.

Instances are plain counters with **no internal lock** — every writer in
this repo already mutates its stats object under a lock
(``BatchServer._stats_lock``, the admission queue's drain lock), and the
histogram inherits that discipline rather than double-locking.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

#: smallest resolvable latency (seconds); everything below lands in bucket 0
MIN_LATENCY_S = 1e-6
#: per-bucket growth factor: 2**(1/8) ~ 9.05% relative resolution
GROWTH = 2.0 ** 0.125
_LOG_GROWTH = math.log(GROWTH)
#: bucket count covering [1us, ~2685s) — far past any latency this repo serves
N_BUCKETS = 1 + int(math.ceil(math.log(2.7e9) / _LOG_GROWTH))


def _bucket_of(seconds: float) -> int:
    if seconds <= MIN_LATENCY_S:
        return 0
    idx = 1 + int(math.log(seconds / MIN_LATENCY_S) / _LOG_GROWTH)
    return min(idx, N_BUCKETS - 1)


@dataclass
class LatencyHistogram:
    """Fixed-shape streaming histogram over positive durations (seconds).

    ``record`` is O(1); ``quantile(q)`` returns the **upper edge** of the
    bucket holding the q-th sample — a conservative (never-understated)
    estimate with <= ~9% relative error.  ``merge`` adds another histogram's
    counts, which is what lets per-scenario load reports and global serve
    stats share one implementation.
    """

    counts: np.ndarray = field(
        default_factory=lambda: np.zeros(N_BUCKETS, np.int64))
    n: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    def record(self, seconds: float) -> None:
        seconds = max(0.0, float(seconds))
        self.counts[_bucket_of(seconds)] += 1
        self.n += 1
        self.total_s += seconds
        if seconds > self.max_s:
            self.max_s = seconds

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        self.counts += other.counts
        self.n += other.n
        self.total_s += other.total_s
        self.max_s = max(self.max_s, other.max_s)
        return self

    def quantile(self, q: float) -> float:
        """Upper bucket edge of the q-quantile sample; 0.0 when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.n == 0:
            return 0.0
        rank = max(1, int(math.ceil(q * self.n)))
        idx = int(np.searchsorted(np.cumsum(self.counts), rank))
        edge = MIN_LATENCY_S * GROWTH ** idx
        # never report past the true maximum (the top bucket is wide)
        return min(edge, self.max_s) if self.max_s > 0 else edge

    @property
    def mean_s(self) -> float:
        return self.total_s / self.n if self.n else 0.0

    def percentiles(self) -> dict:
        """The serving-SLO trio, in milliseconds (JSON-friendly)."""
        return {
            "p50_ms": self.quantile(0.50) * 1e3,
            "p99_ms": self.quantile(0.99) * 1e3,
            "p999_ms": self.quantile(0.999) * 1e3,
            "mean_ms": self.mean_s * 1e3,
            "max_ms": self.max_s * 1e3,
            "n": self.n,
        }

    # -- serialization (benchmark artifacts) -------------------------------

    def to_dict(self) -> dict:
        nz = np.flatnonzero(self.counts)
        return {"n": self.n, "total_s": self.total_s, "max_s": self.max_s,
                "buckets": {int(i): int(self.counts[i]) for i in nz}}

    @classmethod
    def from_dict(cls, d: dict) -> "LatencyHistogram":
        h = cls(n=int(d["n"]), total_s=float(d["total_s"]),
                max_s=float(d["max_s"]))
        for i, c in d["buckets"].items():
            h.counts[int(i)] = int(c)
        return h
