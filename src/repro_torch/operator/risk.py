"""Eviction risk: availability-score drift -> predicted pool availability.

The §6.3 result this package operationalises: the availability score is a
*survival covariate* (Cox HR ≈ 0.99 per score point).  Each reconcile
cycle re-scores the live archive (one O(K) stats-backed dispatch —
``RecommendationEngine.score_archive``), then converts each tracked pool's
fresh member scores into the probability its capacity survives the
configured horizon:

- with enough observed interruptions in the CMDB lifetimes table, a
  :class:`~repro_torch.core.survival.SurvivalModel` (pooled Kaplan-Meier baseline
  x Cox hazard ratio) supplies conditional member survival
  ``S(age + h | x) / S(age | x)``;
- before that evidence exists, a score-proportional heuristic
  (``clip(AS/100, 0, 1)``) stands in — scores *are* calibrated
  availability proxies, the model just sharpens them with lived history.

Predicted pool availability is then the capacity-weighted expected alive
fraction against the requested amount; dropping below the operator's risk
threshold is what triggers re-recommendation.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.survival import SurvivalModel, fit_survival_model
from .cmdb import PoolCMDB, TrackedPool

Key = tuple  # (type_name, region, az)


@dataclass
class PoolRisk:
    """One pool's risk verdict for the current cycle."""

    pool_id: int
    predicted_availability: float   # E[min(1, alive cap / amount)] at t + h
    current_fraction: float         # delivered fraction right now
    model_backed: bool              # SurvivalModel vs score heuristic
    triggered: bool
    reason: str | None = None


def fit_from_cmdb(cmdb: PoolCMDB, *, now: float,
                  min_events: int) -> SurvivalModel | None:
    """Fit the survival model off the CMDB lifetimes table.

    Returns ``None`` until the table holds ``min_events`` observed
    interruptions — a hazard ratio fitted on a handful of events is noise
    wearing a confidence interval, and the heuristic fallback is better
    than a confidently wrong model.
    """
    x, dur, ev = cmdb.lifetimes(now)
    if int(ev.sum()) < min_events:
        return None
    model = fit_survival_model(x, dur, ev)
    return model if model.n_events >= min_events else None


def member_survival(pool: TrackedPool, scores: dict[Key, float], *,
                    model: SurvivalModel | None, horizon: float,
                    now: float) -> np.ndarray:
    """P(member survives the next ``horizon`` minutes), per alive member.

    Model-backed members get the conditional survival at their current age
    with their capacity pool's *fresh* score as covariate (drift moves the
    prediction, which is the whole point); without a model the fresh score
    itself is the probability proxy.
    """
    members = pool.alive_members
    if not members:
        return np.zeros(0)
    x = np.array([scores.get(m.key, m.launch_score) for m in members],
                 np.float64)
    if model is None:
        return np.clip(x / 100.0, 0.0, 1.0)
    age = np.array([now - m.launch_t for m in members], np.float64)
    s_now = np.array([model.survival(a, xi)
                      for a, xi in zip(age, x)], np.float64)
    s_then = np.array([model.survival(a + horizon, xi)
                       for a, xi in zip(age, x)], np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        cond = np.where(s_now > 0, s_then / s_now, 0.0)
    return np.clip(cond, 0.0, 1.0)


def assess_pool(pool: TrackedPool, scores: dict[Key, float], *,
                model: SurvivalModel | None, horizon: float, now: float,
                risk_threshold: float) -> PoolRisk:
    """The risk verdict driving re-recommendation for one tracked pool.

    Triggers when the pool is *already* under target (capacity lost) or
    when the survival-weighted expected capacity at ``now + horizon`` falls
    below ``risk_threshold`` of the requested amount.
    """
    current = pool.delivered_fraction()
    if not pool.active:
        # issued-only pools carry no nodes; risk is purely score drift of
        # the recommended roster
        caps = np.ones(len(pool.recommendation.names))
        keys = [(str(t), str(r), str(a)) for t, r, a in zip(
            pool.recommendation.names, pool.recommendation.regions,
            pool.recommendation.azs)]
        x = np.array([scores.get(k, s) for k, s in zip(
            keys, pool.recommendation.availability)], np.float64)
        w = np.asarray(pool.recommendation.counts, np.float64) * caps
        pred = float((w * np.clip(x / 100.0, 0, 1)).sum() / max(w.sum(), 1e-9))
        trig = pred < risk_threshold
        return PoolRisk(pool.pool_id, pred, 1.0, False, trig,
                        "score_drift" if trig else None)
    surv = member_survival(pool, scores, model=model, horizon=horizon,
                           now=now)
    caps = np.array([m.capacity for m in pool.alive_members], np.float64)
    expected_cap = float((caps * surv).sum())
    pred = min(1.0, expected_cap / pool.amount)
    if current < 1.0:
        return PoolRisk(pool.pool_id, pred, current, model is not None,
                        True, "capacity_lost")
    if pred < risk_threshold:
        return PoolRisk(pool.pool_id, pred, current, model is not None,
                        True, "predicted_risk")
    return PoolRisk(pool.pool_id, pred, current, model is not None, False)


def archive_scores(engine, archive) -> dict[Key, float]:
    """Fresh per-key availability scores off the live archive (O(K))."""
    _, avail, _ = engine.score_archive(archive)
    host = archive.host
    return {(str(t), str(r), str(a)): float(s) for t, r, a, s in
            zip(host.names, host.regions, host.azs, avail)}
