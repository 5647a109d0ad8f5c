"""Probing-based availability & interruption experiments (paper §6 methodology).

Implements the Wu et al. / Li et al. measurement protocol the paper adopts:
instead of keeping fleets running, periodically issue lightweight spot
requests, record success/failure, and (for survival experiments) launch and
track node lifetimes until reclaim.

- ``probe_real_availability``: the ground-truth *Real Availability Score*
  (fraction of successful n-node requests over the probing horizon).
- ``run_interruption_experiment``: launches pools and advances market time,
  yielding per-node (duration, event) pairs for Kaplan-Meier / Cox analyses.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .market import SpotMarket


@dataclass
class ProbeResult:
    target: tuple[str, str, str]     # (type, region, az)
    successes: int
    attempts: int

    @property
    def real_availability(self) -> float:
        return 100.0 * self.successes / max(self.attempts, 1)


def probe_real_availability(market: SpotMarket, targets, n_nodes: int = 50, *,
                            period_min: float = 10.0, duration_min: float = 1440.0,
                            launch: bool = False) -> list[ProbeResult]:
    """Send an n-node request for every target every `period_min` minutes."""
    results = {t: ProbeResult(t, 0, 0) for t in targets}
    t_end = market.now + duration_min
    while market.now < t_end:
        for tgt in targets:
            ok, ids = market.request_spot(*tgt, n_nodes, launch=launch)
            res = results[tgt]
            res.attempts += 1
            res.successes += int(ok)
            if ids:
                market.terminate(ids)  # launch-and-scoot: measure, don't hold
        market.advance(market.now + period_min)
    return list(results.values())


@dataclass
class LifetimeData:
    durations: np.ndarray   # minutes alive
    events: np.ndarray      # 1 = interrupted, 0 = censored (survived horizon)
    covariates: np.ndarray  # per-node covariate (e.g. availability score)


def run_interruption_experiment(market: SpotMarket, pools, scores, *,
                                n_nodes: int = 10, horizon_min: float = 1440.0,
                                relaunch: bool = True,
                                relaunch_period_min: float = 60.0) -> LifetimeData:
    """Launch `n_nodes` on each pool, run the market, record lifetimes.

    `pools` : list of (type, region, az); `scores`: matching covariate values.
    With `relaunch`, reclaimed capacity is re-requested every relaunch period —
    the paper's continuous-experiment protocol — otherwise one-shot.
    """
    node_score: dict[int, float] = {}
    for tgt, sc in zip(pools, scores):
        ok, ids = market.request_spot(*tgt, n_nodes)
        for nid in ids:
            node_score[nid] = sc

    t_end = market.now + horizon_min
    next_relaunch = market.now + relaunch_period_min
    while market.now < t_end:
        step_to = min(t_end, next_relaunch)
        market.advance(step_to)
        if relaunch and market.now >= next_relaunch and market.now < t_end:
            for tgt, sc in zip(pools, scores):
                i = market.pool_index[(tgt[0], tgt[1], tgt[2])]
                alive = len(market._alive_by_pool.get(i, []))
                missing = n_nodes - alive
                if missing > 0:
                    ok, ids = market.request_spot(*tgt, missing)
                    for nid in ids:
                        node_score[nid] = sc
            next_relaunch += relaunch_period_min

    durations, events, covs = [], [], []
    for rec in market.records:
        if rec.node_id not in node_score:
            continue
        end = rec.end_t if rec.end_t is not None else t_end
        durations.append(end - rec.launch_t)
        events.append(1 if rec.reason == "interrupted" else 0)
        covs.append(node_score[rec.node_id])
    return LifetimeData(np.asarray(durations, np.float64),
                        np.asarray(events, np.int64),
                        np.asarray(covs, np.float64))
