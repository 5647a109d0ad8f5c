"""Normalizing signal adapters: raw vendor signals -> T3-like columns.

The scoring stack (Eq. 2-4, Algorithm 1) consumes one thing: a per-target
time series on the integer grid ``[0, t_max]`` where *larger means more
capacity headroom* — the T3 column.  Each vendor publishes something else:

- **AWS**: 1-9 placement scores (SPS-shaped, quota-limited);
- **Azure**: 0-4 eviction-rate bands (0 = rarest eviction), with a
  deterministic fraction of queries simply going unanswered;
- **GCP**: preemption fractions in [0, 1] (published stats, no gaps).

An adapter is two pure maps and one probe:

``raw_from_free(f)``
    free capacity -> the vendor's raw signal.  Pure and deterministic, so
    monotone-consistency is directly testable without a market.
``normalize(raw)``
    raw signal -> integer T3-like value on ``[0, t_max]`` (or ``None`` for
    a missing response).  Composed with ``raw_from_free`` it is monotone
    non-decreasing in free capacity — ordering candidates by normalized
    signal never inverts ordering by true headroom.
``probe(market, target, t=None)``
    one live query against the region's :class:`SpotMarket`, returning the
    raw signal or ``None`` (Azure gaps come from the market's own
    deterministic missing-response draws, so replays are exact).

Normalized values land on the same integer grid as native T3, so the
collector's ``"int8"`` host ring stores them exactly and every consumer of
``column()`` sees bit-identical float64 values regardless of vendor.
"""
from __future__ import annotations

import numpy as np

from ..cloudsim.market import SPS_CAP, SpotMarket


class SignalAdapter:
    """Base: vendor raw signal <-> normalized T3-like grid value."""

    #: vendor tag (matches ``VendorProfile.name``)
    vendor: str = "?"

    def __init__(self, t_max: int = SPS_CAP):
        if t_max < 1:
            raise ValueError("t_max must be >= 1")
        self.t_max = int(t_max)

    # -- pure transforms (testable without a market) -----------------------

    def raw_from_free(self, f: float):
        raise NotImplementedError

    def normalize(self, raw) -> int | None:
        raise NotImplementedError

    # -- live probing ------------------------------------------------------

    def probe(self, market: SpotMarket, target, *, t: float | None = None):
        """Raw signal for ``target = (type, region, az)`` (None = missing)."""
        ty, rg, az = target
        f = market.free(t if t is not None else market.now,
                        np.array([market.pool_index[(ty, rg, az)]]))[0]
        return self.raw_from_free(float(f))

    def sample(self, market: SpotMarket, target, *,
               t: float | None = None) -> int | None:
        """Normalized T3-like value, or ``None`` on a missing response."""
        raw = self.probe(market, target, t=t)
        return None if raw is None else self.normalize(raw)

    def _clipped_fraction(self, f: float) -> float:
        return min(max(f, 0.0), float(self.t_max)) / float(self.t_max)


class AwsSpsAdapter(SignalAdapter):
    """AWS: free capacity -> 1-9 placement score -> T3-like grid value."""

    vendor = "aws"

    def raw_from_free(self, f: float) -> int:
        # the vendor buckets headroom into nine placement-score levels
        return 1 + min(8, int(8 * self._clipped_fraction(f)))

    def normalize(self, raw) -> int | None:
        if raw is None:
            return None
        raw = int(np.clip(raw, 1, 9))
        return int(round((raw - 1) / 8 * self.t_max))


class AzureEvictionAdapter(SignalAdapter):
    """Azure: free capacity -> 0-4 eviction-rate band (0 = rarest).

    Missing responses surface as ``None`` straight from the market's
    deterministic azure-profile gap draws (``SpotMarket.sps`` is the
    vendor endpoint that goes dark, so we route the probe through it).
    """

    vendor = "azure"

    def raw_from_free(self, f: float) -> int:
        # high headroom -> low eviction band; five bands like the portal's
        # 0-5% / 5-10% / 10-15% / 15-20% / 20%+ buckets
        return 4 - min(4, int(5 * min(self._clipped_fraction(f), 0.9999)))

    def normalize(self, raw) -> int | None:
        if raw is None:
            return None
        raw = int(np.clip(raw, 0, 4))
        return int(round((4 - raw) / 4 * self.t_max))

    def probe(self, market: SpotMarket, target, *, t: float | None = None):
        ty, rg, az = target
        if market.sps(ty, rg, az, 1, t=t) is None:   # vendor went dark
            return None
        return super().probe(market, target, t=t)


class GcpPreemptionAdapter(SignalAdapter):
    """GCP: free capacity -> preemption fraction in [0, 1] (1 = certain)."""

    vendor = "gcp"

    def raw_from_free(self, f: float) -> float:
        return 1.0 - self._clipped_fraction(f)

    def normalize(self, raw) -> int | None:
        if raw is None:
            return None
        raw = float(np.clip(raw, 0.0, 1.0))
        return int(round((1.0 - raw) * self.t_max))


_ADAPTERS = {
    "sps": AwsSpsAdapter,
    "eviction": AzureEvictionAdapter,
    "preemption": GcpPreemptionAdapter,
}


def adapter_for(signal: str, t_max: int = SPS_CAP) -> SignalAdapter:
    """The adapter class for a ``VendorProfile.signal`` shape."""
    try:
        cls = _ADAPTERS[signal]
    except KeyError:
        raise KeyError(f"no adapter for signal shape {signal!r}; "
                       f"known: {sorted(_ADAPTERS)}") from None
    return cls(t_max=t_max)
