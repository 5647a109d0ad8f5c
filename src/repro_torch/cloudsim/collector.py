"""The Fig. 3 *Data Collector*: periodic USQS/TSTP collection over all targets.

Drives the paper's collection pipeline against the (rate-limited) SPS service:
every ``period_min`` minutes each tracked (type, region, az) target is probed
at the current USQS target count (or refreshed via TSTP for high-precision
mode), and the reconstructed T3 estimate is appended to the archive.

The archive doubles as the engine's history store: ``to_candidate_set``
assembles the (K, T) T3 matrix + catalog attributes for the scoring window —
the same role the paper's object storage + time-series DB play.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.tstp import TSTPResult, find_transition_points
from ..core.types import CandidateSet
from ..core.usqs import T3Estimator, USQSSampler
from .market import SpotMarket
from .sps import SPSQueryService


@dataclass
class CollectorConfig:
    period_min: float = 10.0
    t_min: int = 5
    t_max: int = 50
    step: int = 5
    mode: str = "usqs"            # "usqs" | "tstp" | "full"
    tstp_early_stop: int = 4
    #: host-side T3 ring capacity (columns).  When set, the collector keeps
    #: the last N ticks in a preallocated (K, N) ndarray so a bounded-window
    #: ``to_candidate_set(window=...)`` materializes in O(K*window) instead
    #: of rebuilding the full python-list matrix, and ``column(i)`` (the
    #: live-ingestion feed) is an O(K) slice.  None disables the ring.
    ring_capacity: int | None = None
    #: storage dtype of the host ring.  T3 values are small integer node
    #: counts (``<= t_max``), so "float32" / "int16" / "int8" hold them
    #: exactly at 1/2, 1/4 and 1/8 of the float64 footprint — at
    #: (vendor x region x type) catalog scale the host ring is the
    #: collector's dominant allocation, and "int8" is what lets K grow with
    #: the multi-vendor catalog.  ``column`` / ``to_candidate_set`` still
    #: hand out float64, so every consumer sees bit-identical values
    #: regardless of the ring dtype.  "int8" requires ``t_max <= 127``
    #: (validated at construction).
    ring_dtype: str = "float64"
    #: optional :class:`repro_torch.core.usqs.BudgetedProbeScheduler` (or anything
    #: with a ``plan(cycle) -> list[int]`` of target indices).  When set,
    #: each :meth:`DataCollector.collect_once` probes only the planned
    #: targets; the rest carry their current estimate forward without
    #: spending any query budget.  Indices are positions in the collector's
    #: ``targets`` list.  Like the estimators, scheduler state is a monotone
    #: accumulator — a retried tick after a mid-collection raise re-plans
    #: from current staleness.
    scheduler: object | None = None
    #: fault-injection hook, called as ``fault_hook(tick)`` at the start of
    #: every :meth:`DataCollector.collect_once`.  Raising aborts the tick
    #: before anything is probed or appended — the chaos adapter
    #: (``operator.chaos`` in the reference) models collector outages this way, and the
    #: operator's reconcile loop is what absorbs the raise (bounded retry +
    #: backoff, then a stale-archive warning).  ``None`` disables it.
    fault_hook: object | None = None

    _RING_DTYPES = ("float64", "float32", "int16", "int8")

    def __post_init__(self):
        if self.ring_dtype not in self._RING_DTYPES:
            raise ValueError(
                f"ring_dtype must be one of {self._RING_DTYPES}, "
                f"got {self.ring_dtype!r}")
        if self.ring_dtype == "int8" and self.t_max > 127:
            raise ValueError(
                f"int8 host ring cannot hold T3 values up to t_max={self.t_max} "
                f"exactly (int8 max is 127)")


class DataCollector:
    """Maintains per-target T3 archives via the configured query heuristic."""

    def __init__(self, service: SPSQueryService, targets,
                 config: CollectorConfig | None = None):
        self.service = service
        self.market: SpotMarket = service.market
        self.targets = list(targets)               # [(type, region, az)]
        self.cfg = config or CollectorConfig()
        grid = np.arange(self.cfg.t_min, self.cfg.t_max + 1, self.cfg.step)
        self._samplers = {t: USQSSampler(self.cfg.t_min, self.cfg.t_max, self.cfg.step)
                          for t in self.targets}
        self._estimators = {t: T3Estimator(grid) for t in self.targets}
        self._tstp_cache: dict[tuple, TSTPResult] = {}
        self.times: list[float] = []
        self.t3_archive: dict[tuple, list[int]] = {t: [] for t in self.targets}
        self.t2_archive: dict[tuple, list[int]] = {t: [] for t in self.targets}
        self._tick = 0
        cap = self.cfg.ring_capacity
        # preallocated (K, cap) host ring of the last `cap` T3 columns
        self._ring = (np.zeros((len(self.targets), cap),
                               np.dtype(self.cfg.ring_dtype))
                      if cap else None)
        self._ring_len = 0
        self._static_cols = None     # cached catalog columns (static per run)

    # -- one collection cycle ------------------------------------------------

    def collect_once(self) -> None:
        """One collection cycle over all targets — **atomic** in the archive.

        All per-target probing happens into tick-local buffers; the archive
        (``times`` / ``t3_archive`` / ``t2_archive`` / host ring / ``_tick``)
        is committed only after every target produced a value.  A raise mid
        collection — the configured ``fault_hook``, a rate-limit
        ``QueryLimitExceeded``, a vendor-side error — therefore leaves the
        archive exactly as it was: no target ever holds more columns than
        another, and ``to_candidate_set`` can never assemble a ragged
        window.  (Estimator/TSTP caches may have absorbed partial
        observations before the raise; they are monotone accumulators, so a
        retried tick just continues from them.)
        """
        if self.cfg.fault_hook is not None:
            self.cfg.fault_hook(self._tick)
        planned = (set(self.cfg.scheduler.plan(self._tick))
                   if self.cfg.scheduler is not None else None)
        t3_new: list[int] = []
        t2_new: list[int] = []
        for k, tgt in enumerate(self.targets):
            ty, rg, az = tgt
            if planned is not None and k not in planned:
                # outside this cycle's probe budget: carry the current
                # estimate forward, spend no queries
                if self.cfg.mode == "usqs":
                    t3_new.append(self._estimators[tgt].t3())
                    t2_new.append(-1)
                else:
                    prev3 = self.t3_archive[tgt]
                    prev2 = self.t2_archive[tgt]
                    t3_new.append(prev3[-1] if prev3 else 0)
                    t2_new.append(prev2[-1] if prev2 else -1)
                continue
            if self.cfg.mode == "usqs":
                tc = self._samplers[tgt].next_target()
                sps = self.service.query(ty, rg, az, tc)
                if sps is not None:   # azure-profile queries may be missing
                    self._estimators[tgt].observe(tc, sps, self._tick)
                t3_new.append(self._estimators[tgt].t3())
                t2_new.append(-1)
            elif self.cfg.mode == "tstp":
                res = find_transition_points(
                    lambda n: self.service.query(ty, rg, az, n) or 1,
                    self.cfg.t_min, self.cfg.t_max,
                    cache=self._tstp_cache.get(tgt),
                    early_stop=self.cfg.tstp_early_stop)
                self._tstp_cache[tgt] = res
                t3_new.append(res.t3)
                t2_new.append(res.t2)
            else:  # full scan (ground truth; expensive)
                t3 = t2 = 0
                for n in range(self.cfg.t_min, self.cfg.t_max + 1):
                    s = self.service.query(ty, rg, az, n)
                    if s is not None and s >= 3:
                        t3 = n
                    if s is not None and s >= 2:
                        t2 = n
                t3_new.append(t3)
                t2_new.append(t2)
        # ---- commit (no raises below this line) --------------------------
        self.times.append(self.market.now)
        for tgt, t3, t2 in zip(self.targets, t3_new, t2_new):
            self.t3_archive[tgt].append(t3)
            self.t2_archive[tgt].append(t2)
        if self._ring is not None:
            cap = self._ring.shape[1]
            self._ring[:, self._tick % cap] = t3_new
            self._ring_len = min(self._ring_len + 1, cap)
        self._tick += 1

    def run(self, cycles: int) -> None:
        for _ in range(cycles):
            self.collect_once()
            self.market.advance(self.market.now + self.cfg.period_min)

    # -- archive -> engine candidate set --------------------------------------

    @property
    def ticks(self) -> int:
        """Completed collection cycles (== columns in the full archive)."""
        return self._tick

    def column(self, i: int) -> np.ndarray:
        """The (K,) T3 column of tick ``i`` — the live-ingestion feed.

        O(K) from the host ring when tick ``i`` is still inside it,
        otherwise assembled from the full per-target lists.
        """
        if not -self._tick <= i < self._tick:
            raise IndexError(f"tick {i} not collected yet (have {self._tick})")
        i %= self._tick
        if self._ring is not None and i >= self._tick - self._ring_len:
            return self._ring[:, i % self._ring.shape[1]].astype(np.float64)
        return np.array([self.t3_archive[t][i] for t in self.targets],
                        np.float64)

    def _catalog_columns(self):
        if self._static_cols is None:
            cat = self.market.catalog
            names, regions, azs, fams, cats, vcpus, mems, prices = \
                [], [], [], [], [], [], [], []
            for ty, rg, az in self.targets:
                it = cat.get(ty)
                names.append(ty); regions.append(rg); azs.append(az)
                fams.append(it.family); cats.append(it.category)
                vcpus.append(it.vcpus); mems.append(it.memory_gb)
                prices.append(cat.spot_price(ty, rg))
            self._static_cols = (
                np.array(names), np.array(regions), np.array(azs),
                np.array(fams), np.array(cats),
                np.array(vcpus, np.float64), np.array(mems, np.float64),
                np.array(prices, np.float64))
        return self._static_cols

    def to_candidate_set(self, window: int | None = None) -> CandidateSet:
        """Assemble the (K, T) scoring-window candidate set.

        With a host ring configured (``CollectorConfig.ring_capacity``) and
        a ``window`` the ring still covers, the T3 matrix is two ndarray
        slices — O(K*window) per tick instead of a python-list rebuild of
        the entire history.  Output is identical either way (the regression
        test pins this).
        """
        names, regions, azs, fams, cats, vcpus, mems, prices = \
            self._catalog_columns()
        # window=0 keeps the historical `series[-0:]` (full-history) reading
        w_eff = self._tick if not window else min(window, self._tick)
        if self._ring is not None and 0 < w_eff <= self._ring_len:
            cap = self._ring.shape[1]
            idx = (np.arange(self._tick - w_eff, self._tick)) % cap
            t3 = self._ring[:, idx].astype(np.float64)
        else:
            t3 = np.stack([np.asarray(self.t3_archive[t], np.float64)[
                self._tick - w_eff:] for t in self.targets])
        return CandidateSet(
            names=names, regions=regions, azs=azs, families=fams,
            categories=cats, vcpus=vcpus, memory_gb=mems, prices=prices,
            t3=t3,
        )
