"""Comparison baselines reproduced from the paper's evaluation (§6.4).

- SpotVerse (Son et al., Middleware'24): sum single-node SPS + IF score,
  filter by threshold T (default 4), pick the cheapest survivor.
- AWS SpotFleet allocation strategies: Lowest Price (LP), Capacity Optimized
  (CO), Price-Capacity Optimized (PCO).  SpotFleet internals are undisclosed;
  we model them the way the paper maps them onto W (LP ~ W=0, CO ~ W=1,
  PCO ~ W=0.5) but using only *instantaneous* capacity signals — no history —
  which is exactly the gap SpotVista exploits.
- Naive single-time-point selection on SPS / T3 at request time.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class BaselineChoice:
    index: int
    reason: str


def spotverse_select(sps: np.ndarray, if_score: np.ndarray, prices: np.ndarray,
                     threshold: int = 4) -> BaselineChoice:
    """Filter sps+if >= T, then cheapest.  Falls back to best-total if empty."""
    total = np.asarray(sps) + np.asarray(if_score)
    ok = np.flatnonzero(total >= threshold)
    if ok.size == 0:
        # SpotVerse behaviour when nothing passes: relax to the best total score.
        ok = np.flatnonzero(total == total.max())
    best = ok[np.argmin(np.asarray(prices)[ok])]
    return BaselineChoice(int(best), f"spotverse T={threshold}")


def spotfleet_select(strategy: str, prices: np.ndarray, capacity: np.ndarray) -> BaselineChoice:
    """AWS SpotFleet allocation strategies on instantaneous signals.

    `capacity` is the current T3 (instantaneous multi-node capacity signal).
    """
    prices = np.asarray(prices, np.float64)
    capacity = np.asarray(capacity, np.float64)
    if strategy == "lowest-price":
        return BaselineChoice(int(np.argmin(prices)), "spotfleet LP")
    if strategy == "capacity-optimized":
        best = np.flatnonzero(capacity == capacity.max())
        return BaselineChoice(int(best[np.argmin(prices[best])]), "spotfleet CO")
    if strategy == "price-capacity-optimized":
        # rank-blend: average of price rank (asc) and capacity rank (desc)
        pr = np.argsort(np.argsort(prices))
        cr = np.argsort(np.argsort(-capacity))
        blend = pr + cr
        best = np.flatnonzero(blend == blend.min())
        return BaselineChoice(int(best[np.argmin(prices[best])]), "spotfleet PCO")
    raise ValueError(f"unknown strategy {strategy!r}")


def naive_single_point(metric_now: np.ndarray, prices: np.ndarray) -> BaselineChoice:
    """Highest instantaneous metric (SPS or T3); cheapest among ties (§6.4)."""
    metric_now = np.asarray(metric_now, np.float64)
    best = np.flatnonzero(metric_now == metric_now.max())
    return BaselineChoice(int(best[np.argmin(np.asarray(prices)[best])]), "naive single-point")
