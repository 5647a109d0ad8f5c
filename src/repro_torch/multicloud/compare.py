"""SpotVista vs SpotFleet/SpotVerse across region setups (paper §6.4).

The paper's headline table compares delivered availability and cost savings
of SpotVista against AWS SpotFleet allocation strategies and SpotVerse,
across single-region, multi-AZ and multi-region setups.  This module
replays that comparison inside the multicloud scenario engine:

- **spotvista** runs the full closed loop through the chaos harness
  (:class:`~repro_torch.operator.chaos.ChaosReplay` over an injected
  :class:`~repro_torch.multicloud.federation.MarketFederation` world): history-
  scored recommendation, region-sharded serving, operator reconcile with
  re-recommendation and refill.
- **spotfleet** / **spotfleet_lp** (price-capacity-optimized / lowest-
  price) and **spotverse** select once on *instantaneous* signals — the
  current normalized column, single-node SPS plus interruption-frequency
  bands — launch, and never look back.  No history, no refill: exactly
  the gap the paper's evaluation measures.

Every policy replays against an identically-seeded fresh copy of the same
world, so capacity traces are bit-identical across policies and the only
difference is placement.  Availability is the time-averaged delivered
fraction of the requested capacity; cost savings compare each policy's
realized spot node-hours against the same nodes at on-demand price.
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass

import numpy as np

from ..core.baselines import spotfleet_select, spotverse_select
from ..core.config import EngineConfig
from ..core.types import ResourceRequest
from ..operator.chaos import ChaosReplay, ChaosSchedule
from .scenario import ScenarioConfig, ScenarioEngine

#: the paper's evaluation setups, as scenario-config fragments
SETUPS: dict[str, dict] = {
    "single_region": dict(vendors=("aws",), regions_per_vendor=1,
                          azs_per_region=1),
    "multi_az": dict(vendors=("aws",), regions_per_vendor=1,
                     azs_per_region=3),
    "multi_region": dict(vendors=("aws",), regions_per_vendor=3,
                         azs_per_region=2),
    "multi_cloud": dict(vendors=("aws", "azure", "gcp"),
                        regions_per_vendor=1, azs_per_region=2),
}

POLICIES = ("spotvista", "spotfleet", "spotfleet_lp", "spotverse")


@dataclass
class PolicyResult:
    """What one policy delivered over one replayed setup."""

    policy: str
    setup: str
    availability: float          # time-averaged delivered fraction
    spot_cost: float             # realized $ at spot prices
    od_cost: float               # same node-hours at on-demand prices
    savings_pct: float           # 100 * (1 - spot/od)
    interruptions: int
    launched: int                # nodes ever launched
    shortfall: int               # nodes the initial placement couldn't get

    def to_dict(self) -> dict:
        return asdict(self)


def federation_costs(fed) -> tuple[float, float, int]:
    """(spot $, on-demand $, interruptions) over every node ever launched."""
    now = fed.now
    spot = od = 0.0
    interruptions = 0
    for w in fed.worlds:
        m = w.market
        for rec in m.records:
            end = rec.end_t if rec.end_t is not None else now
            hours = max(0.0, end - rec.launch_t) / 60.0
            t, r, _az = m.pool_keys[rec.pool_idx]
            spot += hours * w.catalog.spot_price(t.name, r)
            od += hours * w.catalog.on_demand_price(t.name, r)
        interruptions += len(m.interruptions)
    return spot, od, interruptions


def _result(policy, setup, fed, availability, launched, shortfall):
    spot, od, interruptions = federation_costs(fed)
    savings = 100.0 * (1.0 - spot / od) if od > 0 else 0.0
    return PolicyResult(
        policy=policy, setup=setup, availability=float(availability),
        spot_cost=float(spot), od_cost=float(od),
        savings_pct=float(savings), interruptions=interruptions,
        launched=launched, shortfall=shortfall)


def replay_spotvista(engine: ScenarioEngine, *, setup: str, window: int,
                     warmup: int, cycles: int, amount: float,
                     reclaims: dict | None = None,
                     engine_config: EngineConfig | None = None,
                     sharded: bool = True, device=None) -> PolicyResult:
    """The full closed loop through the chaos harness.

    ``reclaims`` (cycle -> forced interruptions) is the same symmetric
    pressure :func:`replay_baseline` applies — SpotVista's answer to it is
    the operator's re-recommendation and refill.  The replay serves on
    ``device`` (CUDA unless ``"cpu"``).
    """
    replay = ChaosReplay(
        market=engine.federation, collector=engine.collector,
        window=window, warmup_cycles=warmup, cycles=cycles,
        period_min=engine.scenario.period_min,
        requests=[ResourceRequest(cpus=amount, weight=0.5)],
        schedule=ChaosSchedule(reclaims=dict(reclaims or {})),
        engine_config=engine_config,
        shard_bounds=engine.region_bounds if sharded else None,
        device=device)
    report = replay.run(f"spotvista/{setup}")
    launched = len(engine.federation.records)
    return _result("spotvista", setup, engine.federation,
                   report.delivered_availability, launched, 0)


def replay_baseline(engine: ScenarioEngine, policy: str, *, setup: str,
                    warmup: int, cycles: int, amount: float,
                    reclaims: dict | None = None) -> PolicyResult:
    """One-shot instantaneous-signal selection, then a static replay.

    ``reclaims`` applies the same cycle -> forced-interruption schedule the
    spotvista replay sees, against this policy's own placement — the
    baseline has no operator, so every interruption is permanent capacity
    loss.
    """
    engine.warmup(warmup)
    coll, fed = engine.collector, engine.federation
    cands = coll.to_candidate_set(window=1)
    col = coll.column(coll.ticks - 1)
    targets = coll.targets
    if policy == "spotfleet":
        choice = spotfleet_select("price-capacity-optimized",
                                  cands.prices, col)
    elif policy == "spotfleet_lp":
        choice = spotfleet_select("lowest-price", cands.prices, col)
    elif policy == "spotverse":
        sps1 = np.array([fed.sps(ty, rg, az, 1) or 1
                         for (ty, rg, az) in targets], np.float64)
        ifs = np.array([fed.interruption_free_score(ty, rg)
                        for (ty, rg, _az) in targets], np.float64)
        choice = spotverse_select(sps1, ifs, cands.prices)
    else:
        raise ValueError(f"unknown baseline policy {policy!r}")
    ty, rg, az = targets[choice.index]
    cap = float(cands.vcpus[choice.index])
    need = int(math.ceil(amount / cap))
    node_ids: list[int] = []
    for _ in range(need):
        ok, ids = fed.request_spot(ty, rg, az, 1)
        if not ok:
            break
        node_ids.extend(ids)
    period = engine.scenario.period_min
    reclaims = dict(reclaims or {})
    samples = []
    for c in range(cycles):
        fed.advance(fed.now + period)
        n_reclaim = reclaims.get(c, 0)
        if n_reclaim:
            fed.reclaim(ty, rg, az, n_reclaim)
        alive = sum(1 for nid in node_ids if fed.node(nid).alive)
        samples.append(min(1.0, alive * cap / amount))
    return _result(policy, setup, fed, float(np.mean(samples)),
                   len(node_ids), need - len(node_ids))


def default_reclaims(cycles: int, *, every: int = 5, n: int = 3) -> dict:
    """A steady interruption drumbeat: ``n`` nodes every ``every`` cycles."""
    return {c: n for c in range(every, cycles, every)}


def compare_setup(setup: str, *, policies=POLICIES, seed: int = 0,
                  period_min: float = 30.0, types_per_region: int = 6,
                  window: int = 12, warmup: int = 16, cycles: int = 24,
                  amount: float = 48.0, reclaims: dict | None = None,
                  engine_config: EngineConfig | None = None, device=None
                  ) -> dict[str, PolicyResult]:
    """Replay every policy over identically-seeded copies of one setup.

    Every policy faces the same world (bit-identical capacity traces) and
    the same forced-interruption schedule (``reclaims``; defaults to
    :func:`default_reclaims`) against its own placement.  SpotVista's
    replay serves on ``device`` (CUDA unless ``"cpu"``); the baselines are
    host numpy.
    """
    if reclaims is None:
        reclaims = default_reclaims(cycles)
    out: dict[str, PolicyResult] = {}
    for policy in policies:
        engine = ScenarioEngine(ScenarioConfig(
            seed=seed, period_min=period_min,
            types_per_region=types_per_region, **SETUPS[setup]))
        if policy == "spotvista":
            out[policy] = replay_spotvista(
                engine, setup=setup, window=window, warmup=warmup,
                cycles=cycles, amount=amount, reclaims=reclaims,
                engine_config=engine_config, device=device)
        else:
            out[policy] = replay_baseline(
                engine, policy, setup=setup, warmup=warmup, cycles=cycles,
                amount=amount, reclaims=reclaims)
    return out


def budget_scaling(region_counts=(1, 4, 17), *, budget: int = 64,
                   cycles: int = 20, seed: int = 0,
                   types_per_region: int = 4, azs_per_region: int = 1,
                   period_min: float = 10.0) -> list[dict]:
    """Hold one global probe budget while AWS regions scale 1 -> 4 -> 17.

    Returns one row per region count with the scheduler's realized query
    spend (must never exceed the budget) and the staleness it traded for
    it (bounded by ``ceil(targets / budget)``).
    """
    rows = []
    for n in region_counts:
        eng = ScenarioEngine(ScenarioConfig(
            vendors=("aws",), regions_per_vendor=n,
            types_per_region=types_per_region,
            azs_per_region=azs_per_region,
            budget_per_cycle=budget, seed=seed, period_min=period_min))
        eng.warmup(cycles)
        sched = eng.scheduler
        stale = sched.staleness(cycles)
        rows.append(dict(
            regions=n, targets=eng.n_targets, budget=budget,
            max_queries_per_cycle=int(max(sched.queries_issued)),
            total_queries=int(sum(sched.queries_issued)),
            mean_staleness=float(stale.mean()),
            max_staleness=int(stale.max()),
            staleness_bound=int(math.ceil(eng.n_targets / budget))))
    return rows
