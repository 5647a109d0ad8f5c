"""Survival analysis of spot-instance lifetimes (paper §6.3, Eq. 5-6).

- Kaplan-Meier estimator (Eq. 6): nonparametric survival curve per
  availability-score bin.
- Cox proportional-hazards model (Eq. 5): hazard ratio of the availability
  score, fitted by Newton iteration on the Breslow partial log-likelihood
  with its closed-form first and second derivatives (paper reports HR
  0.9903, i.e. each score point cuts interruption risk by ~0.97%).

A numpy copy of ``repro.core.survival``; results are the reference's, bit
for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


# ---------------------------------------------------------------------------
# Kaplan-Meier
# ---------------------------------------------------------------------------

@dataclass
class KaplanMeier:
    times: np.ndarray       # distinct event times, ascending
    survival: np.ndarray    # S(t) immediately after each event time

    def at(self, t: float) -> float:
        """S(t): survival probability at time t."""
        i = np.searchsorted(self.times, t, side="right") - 1
        return 1.0 if i < 0 else float(self.survival[i])

    def median(self) -> float:
        """Median survival time (inf if the curve never crosses 0.5)."""
        below = np.flatnonzero(self.survival <= 0.5)
        return float(self.times[below[0]]) if below.size else float("inf")


def kaplan_meier(durations, events) -> KaplanMeier:
    """Product-limit estimator.  `events[i]`=1 if interrupted, 0 if censored."""
    durations = np.asarray(durations, np.float64)
    events = np.asarray(events, bool)
    order = np.argsort(durations, kind="stable")
    d_sorted, e_sorted = durations[order], events[order]
    times = np.unique(d_sorted[e_sorted])
    n = len(d_sorted)
    surv = np.empty(len(times))
    s = 1.0
    for k, t in enumerate(times):
        at_risk = n - np.searchsorted(d_sorted, t, side="left")
        d_t = int(((d_sorted == t) & e_sorted).sum())
        s *= (at_risk - d_t) / at_risk
        surv[k] = s
    return KaplanMeier(times=times, survival=surv)


# ---------------------------------------------------------------------------
# Cox proportional hazards (single covariate, Breslow ties)
# ---------------------------------------------------------------------------

@dataclass
class CoxPHResult:
    beta: float
    hazard_ratio: float
    se: float
    ci_low: float            # 95% CI on the hazard ratio
    ci_high: float
    p_value: float
    converged: bool


def _cox_derivatives(beta, x_s, risk_starts, e_s):
    """Breslow partial log-likelihood derivatives (float64 suffix sums).

    Risk set of subject i is the suffix x_s[risk_starts[i]:].  Returns
    (neg_grad, information) for the single-covariate model:
        dl/db   = sum_events [x_i - S1(i)/S0(i)]
        -d2l/db2 = sum_events [S2(i)/S0(i) - (S1(i)/S0(i))^2]
    with Sk(i) = sum_{j in risk set} x_j^k exp(x_j beta).
    """
    w = np.exp(x_s * beta - np.max(x_s * beta))          # stabilised
    s0 = np.cumsum(w[::-1])[::-1]
    s1 = np.cumsum((w * x_s)[::-1])[::-1]
    s2 = np.cumsum((w * x_s * x_s)[::-1])[::-1]
    r = risk_starts[e_s]
    mean = s1[r] / s0[r]
    grad = float(np.sum(x_s[e_s] - mean))
    info = float(np.sum(s2[r] / s0[r] - mean * mean))
    return grad, info


def cox_ph(x, durations, events, *, max_iter: int = 100, tol: float = 1e-10) -> CoxPHResult:
    """Fit h(t|x) = h0(t) exp((x - xbar) beta) by Newton on the partial likelihood."""
    x = np.asarray(x, np.float64)
    durations = np.asarray(durations, np.float64)
    events = np.asarray(events, bool)
    order = np.argsort(durations, kind="stable")
    d_s, x_s, e_s = durations[order], x[order], events[order]
    x_s = x_s - x_s.mean()  # paper centres the covariate (Eq. 5)
    # risk set of subject i = all with duration >= d_i → first index with that duration
    risk_starts = np.searchsorted(d_s, d_s, side="left")

    beta = 0.0
    converged = False
    info = 0.0
    for _ in range(max_iter):
        grad, info = _cox_derivatives(beta, x_s, risk_starts, e_s)
        if info <= 0:
            break
        step = grad / info
        beta += step
        if abs(step) < tol * max(abs(beta), 1.0):
            converged = True
            break
    _, info = _cox_derivatives(beta, x_s, risk_starts, e_s)
    se = 1.0 / np.sqrt(info) if info > 0 else float("inf")
    z = beta / se if se > 0 else 0.0
    from scipy.stats import norm
    p = 2 * (1 - norm.cdf(abs(z)))
    return CoxPHResult(
        beta=float(beta),
        hazard_ratio=float(np.exp(beta)),
        se=float(se),
        ci_low=float(np.exp(beta - 1.96 * se)),
        ci_high=float(np.exp(beta + 1.96 * se)),
        p_value=float(p),
        converged=converged,
    )


# ---------------------------------------------------------------------------
# Covariate-conditioned survival: KM baseline x Cox hazard ratio
# ---------------------------------------------------------------------------

@dataclass
class SurvivalModel:
    """S(t | x) — the closed-loop operator's eviction-risk primitive.

    Combines the two §6.3 estimators into one predictive surface: the
    Kaplan-Meier curve of the pooled lifetimes approximates the baseline
    survival at the mean covariate, and the Cox hazard ratio shifts it per
    candidate via the proportional-hazards identity

        ``S(t | x) = S0(t) ** exp(beta * (x - x_mean))``.

    (Using the pooled KM as ``S0`` is the standard quick approximation —
    exact Breslow baselines differ in the tails; the operator consumes the
    *ordering and threshold crossing* of these probabilities, for which the
    approximation is well inside the survival estimate's own noise.)

    ``n_events`` lets callers gate on how much interruption evidence the fit
    actually saw — the operator refuses to trust a model fitted on fewer
    events than its configured floor and falls back to a score-only
    heuristic instead.
    """

    km: KaplanMeier
    cox: CoxPHResult
    x_mean: float
    n_events: int

    def survival(self, t: float, x) -> np.ndarray:
        """P(lifetime > t) for covariate value(s) ``x`` (vectorised)."""
        x = np.asarray(x, np.float64)
        base = self.km.at(t)
        return np.power(base, np.exp(self.cox.beta * (x - self.x_mean)))


def fit_survival_model(x, durations, events, **cox_kwargs) -> SurvivalModel:
    """Fit the KM baseline + Cox hazard-ratio pair on one lifetime table.

    ``x`` is the per-subject covariate (the operator feeds the availability
    score at launch), ``durations`` the observed lifetimes, ``events`` the
    interruption indicators (0 = censored, still running or cleanly
    terminated).  Degenerate inputs are handled, not raised: with zero
    events the KM curve is flat 1.0 and the Cox fit returns beta = 0 — the
    model then predicts certain survival, which is exactly what the data
    says and why callers should check :attr:`SurvivalModel.n_events`.
    """
    x = np.asarray(x, np.float64)
    events_arr = np.asarray(events, bool)
    cox = cox_ph(x, durations, events_arr, **cox_kwargs)
    km = kaplan_meier(durations, events_arr)
    return SurvivalModel(km=km, cox=cox, x_mean=float(x.mean()) if x.size else 0.0,
                         n_events=int(events_arr.sum()))
