"""Uniform Spacing Query Sampling (USQS) — paper §3.1.

Instead of querying every node count each cycle, USQS probes one target count
``T_c`` per cycle, advancing by a fixed step ``T_s`` and wrapping from
``T_max`` back to ``T_min``.  A full sweep of the support therefore takes
``(floor((T_max - T_min)/T_s) + 1) * p`` minutes (the staleness bound from
§3.1), while query cost per cycle drops from O(T_max) to O(1).

The estimator half reconstructs T3 (largest node count with SPS == 3) from the
sparse samples by carrying forward the most recent observation per grid point
and exploiting the monotone non-increasing SPS(n) property.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterator

import numpy as np

QueryFn = Callable[[int], int]  # node count -> SPS in {1, 2, 3} (0 = unknown)


@dataclass
class USQSSampler:
    """Cycles the probe target across the sampling grid."""

    t_min: int = 5
    t_max: int = 50
    step: int = 5
    _cursor: int = field(default=0, init=False)

    @property
    def grid(self) -> np.ndarray:
        return np.arange(self.t_min, self.t_max + 1, self.step)

    @property
    def cycle_length(self) -> int:
        return len(self.grid)

    def next_target(self) -> int:
        tc = int(self.grid[self._cursor])
        self._cursor = (self._cursor + 1) % self.cycle_length
        return tc

    def targets(self, n: int) -> Iterator[int]:
        for _ in range(n):
            yield self.next_target()


@dataclass
class T3Estimator:
    """Carry-forward T3 reconstruction from USQS samples.

    Keeps the latest SPS observation per grid point.  Because SPS(n) is
    monotone non-increasing in n, the estimate is the largest grid point whose
    latest observation is 3; observations of SPS < 3 at smaller counts
    invalidate stale 3s above them (the shared capacity pool shrank).
    """

    grid: np.ndarray

    def __post_init__(self):
        self.grid = np.asarray(self.grid, np.int64)
        self._last = np.zeros(len(self.grid), np.int64)   # 0 = never observed
        self._stamp = np.full(len(self.grid), -1, np.int64)

    def observe(self, node_count: int, sps: int, t: int = 0) -> None:
        i = int(np.searchsorted(self.grid, node_count))
        if i >= len(self.grid) or self.grid[i] != node_count:
            raise ValueError(f"{node_count} not on USQS grid {self.grid}")
        self._last[i] = sps
        self._stamp[i] = t
        if sps < 3:
            # Monotonicity: anything above this count observed *earlier* as 3
            # cannot still be trusted.
            stale = (np.arange(len(self.grid)) > i) & (self._stamp < t) & (self._last == 3)
            self._last[stale] = 0
        elif sps == 3:
            # Monotonicity the other way: smaller counts must be >= 3 now.
            below = (np.arange(len(self.grid)) < i) & (self._stamp < t) & (self._last < 3) & (self._last > 0)
            self._last[below] = 0

    def t3(self) -> int:
        """Largest grid point whose latest observation is SPS == 3 (0 if none)."""
        hits = self.grid[self._last == 3]
        return int(hits.max()) if hits.size else 0


@dataclass
class BudgetedProbeScheduler:
    """Allocates a global per-cycle probe budget across (vendor, region) targets.

    The single-market collector probes every target every cycle — fine for one
    region, quota suicide for 17.  This scheduler generalizes USQS's "spread
    queries over time" idea across *targets*: each cycle it plans at most
    ``budget_per_cycle`` probes (globally, across every vendor and region),
    subject to optional per-region caps, choosing targets by **staleness** —
    never-probed targets first, then longest-since-probed — with a rotating
    index tiebreak so equal-staleness targets share the budget fairly instead
    of starving the tail.  Adding regions therefore degrades *staleness*
    gracefully (bounded by ``ceil(K / budget)`` cycles) instead of blowing the
    query budget.

    ``region_keys[k]`` is the rate-limit key of target ``k`` — use
    ``"vendor/region"`` strings so per-region caps compose across vendors.
    State is a monotone accumulator (like :class:`T3Estimator`): a retried
    cycle after a mid-collection raise just re-plans from current staleness.
    """

    region_keys: list[str]
    budget_per_cycle: int
    region_limits: dict[str, int] | None = None

    def __post_init__(self):
        self.region_keys = list(self.region_keys)
        if self.budget_per_cycle < 1:
            raise ValueError("budget_per_cycle must be >= 1")
        self.region_limits = dict(self.region_limits or {})
        self._last = np.full(len(self.region_keys), -1, np.int64)
        #: per-plan probe counts — the benchmark's budget-held evidence
        self.queries_issued: list[int] = []

    @property
    def n_targets(self) -> int:
        return len(self.region_keys)

    def staleness(self, cycle: int) -> np.ndarray:
        """Cycles since each target was last planned (cycle+1 if never)."""
        return np.where(self._last < 0, cycle + 1, cycle - self._last)

    def plan(self, cycle: int) -> list[int]:
        """Target indices to probe this cycle (sorted, <= budget_per_cycle)."""
        k = np.arange(self.n_targets)
        # primary: staleness desc; tiebreak: index rotated by cycle so ties
        # rotate through the target list rather than always favouring low k
        order = np.lexsort(((k - cycle) % max(self.n_targets, 1),
                            -self.staleness(cycle)))
        chosen: list[int] = []
        used: dict[str, int] = {}
        for i in order:
            if len(chosen) >= self.budget_per_cycle:
                break
            r = self.region_keys[i]
            lim = self.region_limits.get(r)
            if lim is not None and used.get(r, 0) >= lim:
                continue
            chosen.append(int(i))
            used[r] = used.get(r, 0) + 1
        self._last[chosen] = cycle
        self.queries_issued.append(len(chosen))
        return sorted(chosen)


def run_usqs(query: QueryFn, sampler: USQSSampler, cycles: int,
             estimator: T3Estimator | None = None) -> tuple[np.ndarray, np.ndarray, int]:
    """Drive `cycles` USQS probes against `query`.

    Returns (per-cycle T3 estimates, per-cycle raw SPS observations, queries used).
    """
    est = estimator or T3Estimator(sampler.grid)
    t3s = np.zeros(cycles, np.int64)
    raw = np.zeros(cycles, np.int64)
    for t in range(cycles):
        tc = sampler.next_target()
        sps = query(tc)
        est.observe(tc, sps, t)
        raw[t] = sps
        t3s[t] = est.t3()
    return t3s, raw, cycles
