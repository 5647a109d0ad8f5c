"""The quantized archive tier's correctness contract, made checkable.

A copy of ``repro.core.quantized`` (host-side numpy, no framework).  Storing
T3 windows as int8 (or bf16) perturbs every sample by at most half the
per-candidate quantisation step (``repro_torch.parallel.compression``).  This
module propagates that per-sample budget through the scoring chain into two
artifacts the parity suites and benchmarks consume:

1. :func:`score_bound` — a per-request bound ``B`` on how far any masked
   candidate's combined score (Eq. 4) can drift from the float32 tier's.
2. :func:`pool_decision_margin` — the float32 path's smallest *decision
   margin*, in units of ``B``: how close any comparison Algorithm 1 makes
   (score ordering, ceil boundaries of the all-prefix allocation scan, the
   final count row) comes to flipping under a per-candidate drift of ``B``.

The contract: **margin > 1 implies the quantized tier's pool is
bit-identical to the float32 tier's** (every decision is too far from its
boundary for a <= B drift to flip it).  Margin <= 1 is a *tie inside the
bound* — the tiers may legitimately diverge, and :func:`check_pool_parity`
flags it (``tie = True``) instead of hiding it; a divergence with margin
> 1 is a genuine contract violation and stays a hard failure.

Derivation sketch (per raw statistic ``v`` with per-candidate drift ``d`` and
masked-lane maximum ``D``): Eq. 3 normalises ``n = (v - lo) / r`` over the
masked range ``r``; the perturbed lo/hi each move by <= D, so
``|dn| <= (d + 3D) / (r - 2D)`` (degenerate when ``r <= 2D`` — the bound
goes infinite and everything is a tie, which is the honest answer for an
archive whose spread is below the quantisation step).  The availability
score ``AS = 100 * a3 * (1 + lam * (m - sigma))`` with ``a3 <= 1`` and
``|m - sigma| <= 1`` then drifts by at most
``100 * ((1 + lam) * dn_area + lam * (dn_slope + dn_std))``, and the
combined score by ``weight`` times that (cost scores consume unquantized
catalog columns — identical in both tiers).  Raw-statistic drifts from an
``err <= step / 2`` per-sample budget: trapezoid area <= ``(T - 1) * step/2``
(weights sum to T - 1), slope <= ``step/2 * sum|t_c| / sum t_c^2``, std <=
``step/2`` (std is ``||.||_2 / sqrt(T)``-Lipschitz).

Everything here is host-side numpy over a single request row — it runs in
tests and benchmark parity gates, never on the serving path.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .scoring import CandidateStats


class QuantizedParity(NamedTuple):
    """Outcome of one float32-vs-quantized pool comparison."""

    identical: bool     # pools bit-identical (names, counts, hourly cost)
    tie: bool           # some decision margin <= the score bound
    margin: float       # min decision margin, in units of ``bound``
    bound: float        # per-request combined-score drift bound B

    @property
    def ok(self) -> bool:
        """The contract holds: identical pools, or a flagged tie."""
        return self.identical or self.tie


def stat_bounds(step: np.ndarray, length: float) -> CandidateStats:
    """Per-candidate raw-statistic drift bounds from a per-sample step.

    ``step`` is the per-candidate quantisation step (one int8 code's width —
    ``compression.candidate_scales``); each stored sample drifts from its
    float32 source by at most ``step / 2``.  Returns the induced worst-case
    drift of the raw Eq. 3 reductions as a :class:`CandidateStats` of bounds.
    """
    h = 0.5 * np.asarray(step, np.float64)
    T = float(length)
    area = h * (T - 1.0 if T > 1 else 0.5)
    if T > 1:
        t_c = np.arange(T) - (T - 1.0) / 2.0
        slope = h * np.abs(t_c).sum() / (t_c @ t_c)
    else:
        slope = np.zeros_like(h)        # slope is 0 by convention at T == 1
    return CandidateStats(area, slope, h.copy())


def _normalized_bound(v: np.ndarray, d: np.ndarray, mask: np.ndarray) -> float:
    """Worst-case drift of a masked-MinMax-normalised statistic."""
    v = np.asarray(v, np.float64)[mask]
    d = np.asarray(d, np.float64)[mask]
    D = float(d.max()) if d.size else 0.0
    if D == 0.0:
        return 0.0
    r = float(v.max() - v.min())
    if r <= 2.0 * D:
        return np.inf       # spread below the quantisation step: all ties
    return 4.0 * D / (r - 2.0 * D)


def score_bound(stats: CandidateStats, bounds: CandidateStats,
                mask: np.ndarray, lam: float, weight: float) -> float:
    """Per-request combined-score (Eq. 4) drift bound ``B``.

    ``stats`` are the float32 tier's raw candidate statistics, ``bounds``
    the per-candidate raw drifts (:func:`stat_bounds`), ``mask`` the
    request's filter lanes, ``lam`` / ``weight`` its Eq. 3/4 parameters.
    """
    mask = np.asarray(mask, bool)
    dn_area = _normalized_bound(stats.area, bounds.area, mask)
    dn_slope = _normalized_bound(stats.slope, bounds.slope, mask)
    dn_std = _normalized_bound(stats.std, bounds.std, mask)
    b_as = 100.0 * ((1.0 + lam) * dn_area + lam * (dn_slope + dn_std))
    return float(weight * b_as)


def _ceil_margins(x: np.ndarray, dx: np.ndarray) -> np.ndarray:
    """Distance of each ``ceil`` operand from its integer boundary, in
    units of its own drift bound ``dx`` (inf where ``dx == 0``)."""
    frac = np.minimum(x % 1.0, 1.0 - (x % 1.0))
    return np.where(dx > 0, frac / np.where(dx > 0, dx, 1.0), np.inf)


def pool_decision_margin(comb: np.ndarray, caps: np.ndarray, amount: float,
                         mask: np.ndarray, bound: float, *,
                         max_types: int | None = None) -> float:
    """Smallest decision margin of Algorithm 1 on the float32 score row.

    Replays every comparison the all-prefix scan makes — adjacent score
    gaps (ordering), the ``ceil`` boundaries of the per-prefix ``top`` /
    ``newest`` allocations (termination), and the chosen prefix's full
    count row — and returns the minimum distance-to-flip in units of
    ``bound``.  ``> 1`` certifies that a per-candidate combined-score drift
    of <= ``bound`` cannot change the pool; ``<= 1`` marks a tie.

    Covers the default pool path only.  A ``max_types`` cap adds
    score-proportional re-allocation boundaries this replay does not model
    — rather than certify a margin that ignores them (a silently-wrong
    "no tie" answer), passing ``max_types`` raises ``NotImplementedError``.
    Run quantized-parity suites with ``max_types=None``.
    """
    if max_types is not None:
        raise NotImplementedError(
            "pool_decision_margin does not model the max_types "
            "re-allocation boundaries; a margin computed without them "
            "could certify a pool that the cap's proportional refill "
            "would in fact flip — run parity checks with max_types=None")
    if bound == 0.0:
        return np.inf
    if not np.isfinite(bound):
        return 0.0
    mask = np.asarray(mask, bool)
    comb = np.asarray(comb, np.float64)
    # Same ordering as greedy_pool_masked: score-descending, stable by
    # original index, masked lanes dropped (they sort strictly after).
    order = np.argsort(-comb, kind="stable")
    order = order[mask[order]]
    s = comb[order]
    c = np.asarray(caps, np.float64)[order]
    m = len(s)
    margins = [np.inf]
    if m > 1:
        margins.append(float((s[:-1] - s[1:]).min()) / (2.0 * bound))
    if s[0] <= bound:       # everything within the bound of score zero
        return 0.0
    S = np.cumsum(s)
    k = np.arange(1, m + 1, dtype=np.float64)
    dS = k * bound
    with np.errstate(divide="ignore", invalid="ignore"):
        # top[k] = ceil(s_0 * R / (S_k * c_0));  newest[k] = ceil(s_k * R /
        # (S_k * c_k)).  |dx| <= (R / (S c)) * bound + x * dS / S.
        for sj, cj in ((np.full(m, s[0]), np.full(m, c[0])), (s, c)):
            x = sj * amount / (S * cj)
            dx = amount / (S * cj) * bound + x * dS / S
            margins.append(float(_ceil_margins(x, dx).min()))
        # The termination prefix the float32 scan actually picks, then the
        # count row ceil margins at that prefix (every member j <= k_best).
        top = np.ceil(s[0] * amount / (S * c[0]))
        newest = np.ceil(s * amount / (S * c))
        prev = np.concatenate([[np.inf], top[:-1]])
        term = (top >= prev) | (newest == 0)
        term[0] = newest[0] == 0
        k_best = (int(np.argmax(term)) - 1 if term.any() else m - 1)
        k_best = max(k_best, 0)
        j = np.arange(k_best + 1)
        x = s[j] * amount / (S[k_best] * c[j])
        dx = (amount / (S[k_best] * c[j]) * bound
              + x * dS[k_best] / S[k_best])
        margins.append(float(_ceil_margins(x, dx).min()))
    return float(min(margins))


def pools_identical(a, b) -> bool:
    """Bit-identical recommendation pools: members, order, counts, cost."""
    return (list(a.names) == list(b.names)
            and np.array_equal(a.counts, b.counts)
            and list(a.regions) == list(b.regions)
            and list(a.azs) == list(b.azs)
            and a.hourly_cost == b.hourly_cost)


def check_pool_parity(rec_f32, rec_q, comb_f32: np.ndarray,
                      caps: np.ndarray, amount: float, mask: np.ndarray,
                      bound: float, *,
                      max_types: int | None = None) -> QuantizedParity:
    """Apply the tier contract to one request's float32/quantized pool pair.

    Returns a :class:`QuantizedParity`; callers assert ``.ok`` — identical
    pools, or a divergence explained (and flagged) by a decision margin
    inside the score bound.  A divergence with ``margin > 1`` leaves
    ``ok = False``: the documented error budget failed to contain the
    drift, which is exactly what the parity suites must catch.  Requests
    carrying a ``max_types`` cap are unsupported, as for
    :func:`pool_decision_margin` (raises ``NotImplementedError``).
    """
    margin = pool_decision_margin(comb_f32, caps, amount, mask, bound,
                                  max_types=max_types)
    return QuantizedParity(
        identical=pools_identical(rec_f32, rec_q),
        tie=margin <= 1.0, margin=margin, bound=bound)
