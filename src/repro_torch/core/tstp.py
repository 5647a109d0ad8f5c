"""Tracking Score Transition Points (TSTP) — paper §3.2.

Finds T3 (largest node count with SPS == 3) and T2 (largest with SPS >= 2)
by binary search over the monotone non-increasing SPS(n) staircase, with the
paper's two complementary optimisations:

- **caching**: warm-start each cycle's search at the previous cycle's value —
  a single probe usually collapses the bracket to a small neighbourhood
  because SPS moves slowly between cycles;
- **early stopping**: terminate once the bracket width drops below ``e`` —
  an approximate transition point is enough for stability scoring, and the
  last few halvings are the expensive, low-value queries.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

QueryFn = Callable[[int], int]  # node count -> SPS in {1, 2, 3}


@dataclass
class TSTPResult:
    t3: int
    t2: int
    queries: int


def _find_threshold(query: QueryFn, level: int, lo: int, hi: int,
                    cached: int | None, early_stop: int,
                    counter: list[int]) -> int:
    """Largest n in [lo-1, hi] with SPS(n) >= level (lo-1 means 'none').

    Maintains the invariant SPS(lo) >= level (or lo == lo_bound-1) and
    SPS(hi+1) < level (or hi == hi_bound).
    """
    lo_bound, hi_bound = lo, hi

    def probe(n: int) -> bool:
        counter[0] += 1
        return query(n) >= level

    # Cache warm start: galloping (exponential) search outward from the
    # cached value — O(log drift) probes when the transition moved little
    # since the last cycle (the paper's temporal-continuity argument).
    lo -= 1  # allow "no count satisfies level"
    if cached is not None and lo_bound <= cached <= hi_bound:
        if probe(cached):
            lo = cached
            step = 1
            while lo + step <= hi:
                if probe(min(lo + step, hi)):
                    lo = min(lo + step, hi)
                    step *= 2
                else:
                    hi = min(lo + step, hi) - 1
                    break
        else:
            hi = cached - 1
            step = 1
            while hi >= lo_bound:
                nxt = max(hi - step + 1, lo_bound)
                if probe(nxt):
                    lo = nxt
                    break
                hi = nxt - 1
                step *= 2
    while hi - lo > max(early_stop, 0):
        mid = (lo + hi + 1) // 2
        if probe(mid):
            lo = mid
        else:
            hi = mid - 1
    # Early-stopped: return the midpoint of the residual bracket (biased to the
    # known-good side when the bracket is fully resolved).
    return lo if hi == lo else (lo + hi + 1) // 2


def find_transition_points(query: QueryFn, t_min: int = 1, t_max: int = 50, *,
                           cache: TSTPResult | None = None,
                           early_stop: int = 0) -> TSTPResult:
    """Locate T3 and T2 via (warm-started, early-stopped) binary search."""
    counter = [0]
    t3 = _find_threshold(query, 3, t_min, t_max,
                         cache.t3 if cache else None, early_stop, counter)
    # T2 >= T3 by monotonicity, so the T2 search starts at max(T3, t_min).
    t2 = _find_threshold(query, 2, max(t3, t_min), t_max,
                         cache.t2 if cache else None, early_stop, counter)
    return TSTPResult(t3=max(t3, 0), t2=max(t2, t3, 0), queries=counter[0])


def full_scan(query: QueryFn, t_min: int = 1, t_max: int = 50) -> TSTPResult:
    """Ground-truth scan: query every node count (O(T_max) queries)."""
    t3 = t2 = 0
    n_q = 0
    for n in range(t_min, t_max + 1):
        s = query(n)
        n_q += 1
        if s >= 3:
            t3 = n
        if s >= 2:
            t2 = n
    return TSTPResult(t3=t3, t2=max(t2, t3), queries=n_q)
