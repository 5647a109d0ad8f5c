"""The scenario engine: vendor worlds -> scheduled probing -> sharded serving.

:class:`ScenarioEngine` assembles the whole multi-vendor pipeline from one
:class:`ScenarioConfig`:

1. one ``(Catalog, SpotMarket)`` world per (vendor, region), each with the
   vendor's own families, UTC geography, market process, and signal adapter
   (:mod:`~repro_torch.multicloud.vendors`, :mod:`~repro_torch.multicloud.adapters`);
2. a :class:`MultiCloudCollector` holding the **region-contiguous** global
   target list — vendor by vendor, region by region — so per-region shards
   are contiguous slices of the candidate axis and the exact shard merge
   protocol
   applies unchanged;
3. a :class:`~repro_torch.core.usqs.BudgetedProbeScheduler` spreading one global
   per-cycle query budget across every (vendor, region) with per-region
   caps and staleness-driven prioritization;
4. a :class:`~repro_torch.multicloud.federation.MarketFederation` so the operator
   / chaos harness drives all regions through one market surface;
5. region-sharded serving: ``build_ingestor`` stages one rolling-ring shard
   per region (``shard_bounds = region_bounds``) feeding a single
   cross-region ``recommend_batch``.

The collector duck-types the :class:`~repro_torch.cloudsim.collector.DataCollector`
surface the stream/operator layers consume (``ticks`` / ``column`` /
``to_candidate_set`` / ``collect_once`` / ``times``), stores normalized
values on the integer grid in an ``"int8"`` host ring by default, and
commits atomically exactly like the single-market collector.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from .._device import resolve_device
from ..core.config import EngineConfig
from ..core.types import CandidateSet
from ..core.usqs import BudgetedProbeScheduler
from .adapters import SignalAdapter, adapter_for
from .federation import MarketFederation
from .vendors import VendorProfile, build_region, get_vendor


@dataclass(frozen=True)
class ScenarioConfig:
    """One multi-vendor, multi-region scenario, declaratively.

    ``regions`` maps vendor name -> tuple of region names; ``None`` takes
    the first ``regions_per_vendor`` regions of each vendor's registry.
    ``types_per_region`` / ``azs_per_region`` bound the per-region target
    count (the full family x size catalog is SpotLake-scale; tests and
    smoke runs want tens of targets, not thousands).  ``budget_per_cycle``
    is the *global* probe budget across every (vendor, region) target —
    ``None`` probes everything every cycle (no scheduler).
    """

    vendors: tuple[str, ...] = ("aws", "azure", "gcp")
    regions: dict | None = None
    regions_per_vendor: int = 1
    seed: int = 0
    period_min: float = 10.0
    t_max: int = 50
    types_per_region: int | None = 8
    azs_per_region: int | None = 2
    ring_capacity: int = 64
    ring_dtype: str = "int8"
    budget_per_cycle: int | None = None
    #: per-region probe caps keyed "vendor/region"; ``None`` derives them
    #: from each vendor's ``region_query_limit`` (scaled to per-cycle)
    region_limits: dict | None = None
    fault_hook: object | None = None

    def vendor_regions(self) -> list[tuple[str, str]]:
        out = []
        for v in self.vendors:
            vp = get_vendor(v)
            if self.regions and v in self.regions:
                names = list(self.regions[v])
            else:
                names = vp.region_names(self.regions_per_vendor)
            out.extend((v, r) for r in names)
        return out


@dataclass
class RegionWorld:
    """One (vendor, region) market world plus its signal adapter."""

    vendor: VendorProfile
    region: str
    catalog: object
    market: object
    adapter: SignalAdapter
    targets: list = field(default_factory=list)   # [(type, region, az)]

    @property
    def key(self) -> str:
        return f"{self.vendor.name}/{self.region}"


class MultiCloudCollector:
    """Scheduler-driven collection over every (vendor, region) target.

    Duck-types the ``DataCollector`` surface: one :meth:`collect_once` per
    cycle probes the scheduler-planned targets through each world's signal
    adapter (normalized onto the shared T3-like integer grid), carries
    every other target's estimate forward, and commits the tick atomically
    — times / per-target series / host ring / tick counter move together
    or not at all.  Targets are region-contiguous; ``region_bounds`` hands
    the per-region ``[start, end)`` extents to the shard layer.
    """

    def __init__(self, worlds: list[RegionWorld], *,
                 federation: MarketFederation,
                 scheduler: BudgetedProbeScheduler | None = None,
                 period_min: float = 10.0,
                 ring_capacity: int = 64, ring_dtype: str = "int8",
                 fault_hook=None):
        if not worlds:
            raise ValueError("need at least one region world")
        self.worlds = worlds
        self.market = federation          # the operator-facing market
        self.scheduler = scheduler
        self.period_min = period_min
        self.fault_hook = fault_hook
        self.targets: list[tuple[str, str, str]] = []
        self._target_world: list[RegionWorld] = []
        bounds, start = [], 0
        for w in worlds:
            self.targets.extend(w.targets)
            self._target_world.extend([w] * len(w.targets))
            bounds.append((start, start + len(w.targets)))
            start += len(w.targets)
        #: contiguous per-region ``[start, end)`` extents — the shard map
        self.region_bounds: tuple[tuple[int, int], ...] = tuple(bounds)
        k = len(self.targets)
        if k == 0:
            raise ValueError("region worlds contributed no targets")
        self.times: list[float] = []
        self.t3_archive: dict[tuple, list[int]] = {t: [] for t in self.targets}
        self._current = np.zeros(k, np.int64)   # carry-forward estimates
        self._tick = 0
        self._ring = np.zeros((k, int(ring_capacity)), np.dtype(ring_dtype))
        self._ring_len = 0
        self._static_cols = None
        self.missing_responses = 0

    # -- one collection cycle ---------------------------------------------

    def collect_once(self) -> None:
        """One atomic cycle: probe planned targets, carry the rest forward."""
        if self.fault_hook is not None:
            self.fault_hook(self._tick)
        planned = (set(self.scheduler.plan(self._tick))
                   if self.scheduler is not None
                   else range(len(self.targets)))
        new = self._current.copy()
        missing = 0
        for k in planned:
            world = self._target_world[k]
            value = world.adapter.sample(world.market, self.targets[k])
            if value is None:          # vendor went dark: keep the estimate
                missing += 1
                continue
            new[k] = value
        # ---- commit (no raises below this line) --------------------------
        self.missing_responses += missing
        self.times.append(self.market.now)
        for tgt, v in zip(self.targets, new):
            self.t3_archive[tgt].append(int(v))
        cap = self._ring.shape[1]
        self._ring[:, self._tick % cap] = new
        self._ring_len = min(self._ring_len + 1, cap)
        self._current = new
        self._tick += 1

    def run(self, cycles: int) -> None:
        for _ in range(cycles):
            self.collect_once()
            self.market.advance(self.market.now + self.period_min)

    # -- archive -> engine candidate set -----------------------------------

    @property
    def ticks(self) -> int:
        return self._tick

    def column(self, i: int) -> np.ndarray:
        """The (K,) normalized column of tick ``i`` (float64, exact)."""
        if not -self._tick <= i < self._tick:
            raise IndexError(f"tick {i} not collected yet (have {self._tick})")
        i %= self._tick
        if i >= self._tick - self._ring_len:
            return self._ring[:, i % self._ring.shape[1]].astype(np.float64)
        return np.array([self.t3_archive[t][i] for t in self.targets],
                        np.float64)

    def _catalog_columns(self):
        if self._static_cols is None:
            names, regions, azs, fams, cats, vcpus, mems, prices = \
                [], [], [], [], [], [], [], []
            for world, (ty, rg, az) in zip(self._target_world, self.targets):
                it = world.catalog.get(ty)
                names.append(ty); regions.append(rg); azs.append(az)
                fams.append(it.family); cats.append(it.category)
                vcpus.append(it.vcpus); mems.append(it.memory_gb)
                prices.append(world.catalog.spot_price(ty, rg))
            self._static_cols = (
                np.array(names), np.array(regions), np.array(azs),
                np.array(fams), np.array(cats),
                np.array(vcpus, np.float64), np.array(mems, np.float64),
                np.array(prices, np.float64))
        return self._static_cols

    def to_candidate_set(self, window: int | None = None) -> CandidateSet:
        names, regions, azs, fams, cats, vcpus, mems, prices = \
            self._catalog_columns()
        w_eff = self._tick if not window else min(window, self._tick)
        if 0 < w_eff <= self._ring_len:
            cap = self._ring.shape[1]
            idx = np.arange(self._tick - w_eff, self._tick) % cap
            t3 = self._ring[:, idx].astype(np.float64)
        else:
            t3 = np.stack([np.asarray(self.t3_archive[t], np.float64)[
                self._tick - w_eff:] for t in self.targets])
        return CandidateSet(
            names=names, regions=regions, azs=azs, families=fams,
            categories=cats, vcpus=vcpus, memory_gb=mems, prices=prices,
            t3=t3,
        )


class ScenarioEngine:
    """Wire a :class:`ScenarioConfig` into the full serving pipeline."""

    def __init__(self, scenario: ScenarioConfig | None = None, **overrides):
        sc = scenario or ScenarioConfig()
        if overrides:
            sc = replace(sc, **overrides)
        self.scenario = sc
        self.worlds: list[RegionWorld] = []
        for vendor, region in sc.vendor_regions():
            vp = get_vendor(vendor)
            catalog, market = build_region(vp, region, seed=sc.seed)
            adapter = adapter_for(vp.signal, t_max=sc.t_max)
            azs = catalog.azs(region)
            if sc.azs_per_region is not None:
                azs = azs[:sc.azs_per_region]
            types = catalog.types
            if sc.types_per_region is not None:
                step = max(len(types) // sc.types_per_region, 1)
                types = types[::step][:sc.types_per_region]
            targets = [(t.name, region, az) for t in types for az in azs]
            self.worlds.append(RegionWorld(
                vendor=vp, region=region, catalog=catalog, market=market,
                adapter=adapter, targets=targets))
        self.federation = MarketFederation(self.worlds)
        self.scheduler = None
        if sc.budget_per_cycle is not None:
            region_keys = [w.key for w in self.worlds
                           for _ in w.targets]
            limits = sc.region_limits
            if limits is None:
                limits = {w.key: w.vendor.region_query_limit
                          for w in self.worlds
                          if w.vendor.region_query_limit is not None}
            self.scheduler = BudgetedProbeScheduler(
                region_keys=region_keys,
                budget_per_cycle=sc.budget_per_cycle,
                region_limits=limits)
        self.collector = MultiCloudCollector(
            self.worlds, federation=self.federation,
            scheduler=self.scheduler, period_min=sc.period_min,
            ring_capacity=sc.ring_capacity, ring_dtype=sc.ring_dtype,
            fault_hook=sc.fault_hook)

    @property
    def region_bounds(self) -> tuple[tuple[int, int], ...]:
        return self.collector.region_bounds

    @property
    def n_targets(self) -> int:
        return len(self.collector.targets)

    def warmup(self, cycles: int) -> None:
        """Seed the scoring window (collect + advance per cycle)."""
        self.collector.run(cycles)

    def build_ingestor(self, config: EngineConfig | None = None, *,
                       window: int, cache=None, sharded: bool = True,
                       name: str = "multicloud", device=None, **kw):
        """Region-sharded (default) live ingestor over the collector.

        One shard per region via ``shard_bounds=region_bounds``, so the
        cross-region ``recommend_batch`` is the exact shard merge over
        per-region rings.  ``sharded=False`` stages the equivalent
        single-device ring (the parity reference).  The rings live on
        ``device``: CUDA unless ``"cpu"``.
        """
        cfg = config or EngineConfig()
        if cache is not None:
            kw["cache"] = cache
        return cfg.build_ingestor(
            self.collector, window=window, name=name,
            shard_bounds=self.region_bounds if sharded else None,
            device=resolve_device(device), **kw)
