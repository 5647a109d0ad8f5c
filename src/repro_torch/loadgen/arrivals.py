"""Arrival processes for the latency-SLO load harness.

Three shapes cover how availability-query traffic actually reaches a
recommendation service:

- :class:`Steady` — homogeneous Poisson, the textbook baseline and the
  calibration anchor (offered load is exactly ``rate``).
- :class:`Diurnal` — inhomogeneous Poisson with a sinusoidal rate, the
  day/night cycle every user-facing service sees.  Sampled by thinning
  (Lewis & Shedler): draw at the peak rate, keep each arrival with
  probability ``rate(t) / peak``.
- :class:`MMPP2` — a 2-state Markov-modulated Poisson process: exponential
  sojourns alternate between a quiet rate and a burst rate.  This is the
  arrival shape of *signal-driven* traffic — availability updates and
  interruption notices arrive in rate-limited bursts (cf. SpotLake's
  per-vendor collectors and the Ding-Dong-Ditch burst analysis), and every
  downstream re-recommendation wave inherits the burstiness.

All processes are deterministic given the caller's ``numpy`` Generator and
return sorted arrival times (seconds, float64) in ``[0, horizon)`` — the
harness replays them against a virtual clock, so an hour-long diurnal cycle
simulates in however long the *service* work actually takes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _poisson_times(rate: float, horizon_s: float, rng) -> np.ndarray:
    """Homogeneous Poisson arrivals in [0, horizon): cumulative Exp gaps."""
    if rate <= 0:
        return np.empty(0, np.float64)
    times = []
    t = 0.0
    # draw gaps in blocks — one rng call per ~expected count, not per event
    block = max(16, int(rate * horizon_s * 1.2) + 16)
    while t < horizon_s:
        gaps = rng.exponential(1.0 / rate, block)
        cum = t + np.cumsum(gaps)
        times.append(cum[cum < horizon_s])
        t = float(cum[-1])
    return np.concatenate(times) if times else np.empty(0, np.float64)


class Arrivals:
    """Interface: ``times(horizon_s, rng) -> sorted float64 seconds``."""

    def times(self, horizon_s: float, rng) -> np.ndarray:
        raise NotImplementedError

    def mean_rate(self) -> float:
        """Long-run average arrivals/second (for load-factor bookkeeping)."""
        raise NotImplementedError


@dataclass(frozen=True)
class Steady(Arrivals):
    """Homogeneous Poisson at ``rate`` requests/second."""

    rate: float

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError("rate must be > 0")

    def times(self, horizon_s: float, rng) -> np.ndarray:
        return _poisson_times(self.rate, horizon_s, rng)

    def mean_rate(self) -> float:
        return self.rate


@dataclass(frozen=True)
class Diurnal(Arrivals):
    """Sinusoidal-rate Poisson: trough ``base_rate``, crest ``peak_rate``.

    ``rate(t) = base + (peak - base) * (1 - cos(2*pi*(t + phase)/period))/2``
    — the crest sits at ``t = period/2 - phase``.  One ``period_s`` is one
    simulated "day"; the harness compresses it to virtual time, so a
    realistic 24 h cycle can be replayed as, say, a 60 s virtual period
    without changing the queueing dynamics relative to service times.
    """

    base_rate: float
    peak_rate: float
    period_s: float
    phase_s: float = 0.0

    def __post_init__(self):
        if not 0 < self.base_rate <= self.peak_rate:
            raise ValueError("need 0 < base_rate <= peak_rate")
        if self.period_s <= 0:
            raise ValueError("period_s must be > 0")

    def rate_at(self, t) -> np.ndarray:
        sweep = (self.peak_rate - self.base_rate) / 2.0
        return self.base_rate + sweep * (
            1.0 - np.cos(2.0 * np.pi * (np.asarray(t) + self.phase_s)
                         / self.period_s))

    def times(self, horizon_s: float, rng) -> np.ndarray:
        cand = _poisson_times(self.peak_rate, horizon_s, rng)
        keep = rng.random(len(cand)) * self.peak_rate <= self.rate_at(cand)
        return cand[keep]

    def mean_rate(self) -> float:
        return (self.base_rate + self.peak_rate) / 2.0


@dataclass(frozen=True)
class MMPP2(Arrivals):
    """2-state Markov-modulated Poisson: quiet/burst alternation.

    The process sits in the quiet state (rate ``rate_low``) for an
    Exp(``mean_low_s``) sojourn, jumps to the burst state (``rate_high``)
    for Exp(``mean_high_s``), and repeats.  Index of dispersion exceeds 1
    whenever the rates differ — arrivals clump, which is exactly the
    worst case for a deadline-batched admission queue (a burst lands an
    entire ladder bucket in one ``max_wait`` window).
    """

    rate_low: float
    rate_high: float
    mean_low_s: float
    mean_high_s: float

    def __post_init__(self):
        if self.rate_low <= 0 or self.rate_high <= 0:
            raise ValueError("rates must be > 0")
        if self.mean_low_s <= 0 or self.mean_high_s <= 0:
            raise ValueError("sojourn means must be > 0")

    def times(self, horizon_s: float, rng) -> np.ndarray:
        out = []
        t = 0.0
        high = False
        while t < horizon_s:
            mean = self.mean_high_s if high else self.mean_low_s
            rate = self.rate_high if high else self.rate_low
            sojourn = float(rng.exponential(mean))
            end = min(t + sojourn, horizon_s)
            seg = _poisson_times(rate, end - t, rng)
            out.append(seg + t)
            t = end
            high = not high
        return np.concatenate(out) if out else np.empty(0, np.float64)

    def mean_rate(self) -> float:
        w_low = self.mean_low_s / (self.mean_low_s + self.mean_high_s)
        return self.rate_low * w_low + self.rate_high * (1.0 - w_low)
