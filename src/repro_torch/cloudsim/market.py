"""Spot-market simulator: capacity pools, SPS semantics, interruptions.

Stands in for the vendor's spot backend.  Each (instance type, AZ) pair owns a
shared capacity pool (the paper's §2 model: "instances of the same type within
an AZ are provisioned from a shared capacity pool").  Capacity follows a
deterministic seeded process calibrated to the paper's measurements:

- daily cycle peaking at local nighttime, dipping during business hours
  (§6.2, Fig. 6), with weekly modulation;
- strongly skewed base-capacity distribution (scarce / moderate / plentiful
  mixture) so the T3 distribution over the USQS grid has entropy ≈ 2.5 bits
  (§3.1.1) and a J-shaped 24h-sustain curve with a 50-cap ceiling effect
  (Fig. 10);
- per-AZ base factors giving >1/3 of types a max-min T3 spread of ~50 across
  AZs (Fig. 9);
- family-level phase/amplitude sharing so adjacent sizes correlate (Fig. 7);
- an "azure" profile with weak seasonality, dominant trend, amplitude regime
  shifts and missing query responses (§6.2, Table 1, §8);
- a "gcp" profile between the two: moderate seasonality, mild trend, higher
  noise, no missing responses (preemption stats are published, not sampled).

Multi-vendor worlds pass ``vendor=`` so every deterministic draw — pool
parameters, missing-response coin flips, reclaim victim selection — is salted
by ``(seed, profile, vendor)``.  Two regions built from structurally identical
configs therefore never replay the same capacity trace.  ``vendor=None``
(default) keeps the historical key shape, so committed benchmark artifacts
stay bit-identical.

SPS semantics: for a request of n nodes against free capacity f,
SPS = 3 if f >= n, 2 if f >= ceil(n/2), else 1 — monotone non-increasing in n
by construction (the property TSTP exploits).  T3_true = clip(floor(f), 0, 50).

Interruptions: when a pool's capacity drops below its committed usage, excess
nodes are reclaimed (seeded-random victims), emitting interruption events with
full lifetimes for the survival analyses.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np

from .catalog import Catalog, InstanceType, REGION_UTC_OFFSET

MINUTES_PER_DAY = 1440
MINUTES_PER_WEEK = 10080
SPS_CAP = 50  # vendor query cap on node count

# Irrational-ish periods (minutes) for the smooth deterministic noise field.
_NOISE_PERIODS = np.array([73.3, 211.7, 487.9, 1013.1])


def _hash_units(key: str, n: int) -> np.ndarray:
    """n deterministic uniforms in [0,1) from a string key."""
    out = np.empty(n)
    for i in range(n):
        h = hashlib.blake2b(f"{key}:{i}".encode(), digest_size=8).digest()
        out[i] = int.from_bytes(h, "little") / 2.0 ** 64
    return out


@dataclass
class NodeRecord:
    node_id: int
    pool_idx: int
    launch_t: float
    end_t: float | None = None
    reason: str | None = None   # "interrupted" | "terminated"

    @property
    def alive(self) -> bool:
        return self.end_t is None


@dataclass
class PoolKey:
    type_name: str
    region: str
    az: str

    def __hash__(self):
        return hash((self.type_name, self.region, self.az))


class SpotMarket:
    """Deterministic, seeded spot-market simulator."""

    def __init__(self, catalog: Catalog, seed: int = 0, profile: str = "aws",
                 *, vendor: str | None = None):
        assert profile in ("aws", "azure", "gcp")
        self.catalog = catalog
        self.seed = seed
        self.profile = profile
        self.vendor = vendor
        self.now = 0.0  # minutes
        self._records: list[NodeRecord] = []
        self._alive_by_pool: dict[int, list[int]] = {}
        if vendor is None:
            rng_seed = seed ^ 0x5F0CAFE
        else:
            # (seed, vendor, region set) → independent victim-selection
            # streams per region world, stable across process restarts
            key = f"{seed}:{vendor}:{','.join(sorted(catalog.regions))}"
            digest = hashlib.blake2b(key.encode(), digest_size=8).digest()
            rng_seed = int.from_bytes(digest, "little")
        self._rng = np.random.default_rng(rng_seed)
        #: append-only interruption event log.  ``advance`` (capacity-driven
        #: reclaims) and :meth:`reclaim` (targeted chaos reclaims) both append
        #: here, so a consumer that missed an ``advance`` return value — the
        #: operator's reconcile loop observes the market, it does not drive
        #: it — can still replay every event via :meth:`events_since`.
        self.interruptions: list[NodeRecord] = []

        pools = catalog.pools()
        self.pool_keys: list[tuple[InstanceType, str, str]] = pools
        self.pool_index: dict[tuple[str, str, str], int] = {
            (t.name, r, az): i for i, (t, r, az) in enumerate(pools)
        }
        P = len(pools)
        self._used = np.zeros(P)

        # ---- deterministic per-pool process parameters -------------------
        base = np.empty(P)
        daily_amp = np.empty(P)
        weekly_amp = np.empty(P)
        daily_phase = np.empty(P)
        weekly_phase = np.empty(P)
        trend = np.empty(P)
        noise_amp = np.empty(P)
        noise_phase = np.empty((P, len(_NOISE_PERIODS)))
        regime_amp = np.ones(P)       # azure amplitude regime-shift factor
        regime_period = np.full(P, np.inf)

        s = f"{seed}:{profile}" if vendor is None else f"{seed}:{profile}:{vendor}"
        self._salt = s
        for i, (t, r, az) in enumerate(pools):
            fam_key = f"{s}:fam:{t.family}:{az}"
            u_fam = _hash_units(fam_key, 4)
            u_pool = _hash_units(f"{s}:pool:{t.name}:{az}", 8)

            # Base capacity: skewed mixture at (family, az) level, shaped by size.
            mix = u_fam[0]
            if mix < 0.30:
                fam_base = 6.0 * u_fam[1]                       # scarce
            elif mix < 0.62:
                fam_base = 10.0 + 60.0 * u_fam[1]               # moderate
            else:
                fam_base = 80.0 + 180.0 * u_fam[1]              # plentiful
            size_factor = (8.0 / t.vcpus) ** 0.45               # small sizes more plentiful
            base[i] = fam_base * size_factor * (0.8 + 0.4 * u_pool[0])

            offset_min = catalog.utc_offset(r) * 60.0
            if profile == "aws":
                daily_amp[i] = 0.25 + 0.35 * u_fam[2]
                weekly_amp[i] = 0.03 + 0.07 * u_pool[1]
                trend[i] = (u_pool[2] - 0.5) * 2e-6 * base[i]
                noise_amp[i] = 0.02 + 0.06 * u_pool[3]
            elif profile == "gcp":  # moderate seasonality, mild trend, noisy
                daily_amp[i] = 0.15 + 0.20 * u_fam[2]
                weekly_amp[i] = 0.02 + 0.05 * u_pool[1]
                trend[i] = (u_pool[2] - 0.5) * 8e-6 * base[i]
                noise_amp[i] = 0.05 + 0.10 * u_pool[3]
            else:  # azure: weak seasonality, strong trend, regime shifts, noise
                daily_amp[i] = 0.02 + 0.10 * u_fam[2]
                weekly_amp[i] = 0.02 + 0.05 * u_pool[1]
                trend[i] = (u_pool[2] - 0.45) * 6e-5 * base[i]
                noise_amp[i] = 0.10 + 0.20 * u_pool[3]
                regime_amp[i] = 0.3 + 0.9 * u_pool[6]
                regime_period[i] = MINUTES_PER_WEEK * (2.0 + 6.0 * u_pool[7])
            # Nighttime peak ~03:00 local, family-synchronised phase jitter.
            daily_phase[i] = (180.0 - offset_min + 60.0 * (u_fam[3] - 0.5))
            weekly_phase[i] = MINUTES_PER_WEEK * u_pool[4]
            noise_phase[i] = 2 * np.pi * _hash_units(f"{s}:noise:{t.name}:{az}", len(_NOISE_PERIODS))

        self._base = base
        self._daily_amp = daily_amp
        self._weekly_amp = weekly_amp
        self._daily_phase = daily_phase
        self._weekly_phase = weekly_phase
        self._trend = trend
        self._noise_amp = noise_amp
        self._noise_phase = noise_phase
        self._regime_amp = regime_amp
        self._regime_period = regime_period
        self._missing_rate = 0.05 if profile == "azure" else 0.0

    # ------------------------------------------------------------------
    # capacity field
    # ------------------------------------------------------------------

    def capacity(self, t: float, idx: np.ndarray | None = None) -> np.ndarray:
        """Deterministic capacity of pools `idx` (all pools if None) at time t."""
        if idx is None:
            idx = slice(None)
        b = self._base[idx]
        daily = self._daily_amp[idx] * np.cos(
            2 * np.pi * (t - self._daily_phase[idx]) / MINUTES_PER_DAY)
        if self.profile == "azure":
            # amplitude regime shifts (square-wave modulation of the seasonal term)
            regime = np.where(
                np.sin(2 * np.pi * t / self._regime_period[idx]) > 0,
                1.0, self._regime_amp[idx])
            daily = daily * regime
        weekly = self._weekly_amp[idx] * np.cos(
            2 * np.pi * (t - self._weekly_phase[idx]) / MINUTES_PER_WEEK)
        noise = self._noise_amp[idx] * np.sin(
            2 * np.pi * t / _NOISE_PERIODS[None, :] + self._noise_phase[idx]
        ).sum(-1) / np.sqrt(len(_NOISE_PERIODS))
        cap = b * (1.0 + daily + weekly + noise) + self._trend[idx] * t
        return np.maximum(cap, 0.0)

    def free(self, t: float, idx: np.ndarray | None = None) -> np.ndarray:
        if idx is None:
            used = self._used
        else:
            used = self._used[idx]
        return np.maximum(self.capacity(t, idx) - used, 0.0)

    # ------------------------------------------------------------------
    # vendor APIs
    # ------------------------------------------------------------------

    def _pool_idx(self, type_name: str, region: str, az: str) -> int:
        return self.pool_index[(type_name, region, az)]

    def sps(self, type_name: str, region: str, az: str, n: int, *,
            t: float | None = None) -> int | None:
        """Vendor SPS endpoint.  Returns None for missing responses (azure)."""
        t = self.now if t is None else t
        if self._missing_rate > 0:
            miss_salt = self.seed if self.vendor is None \
                else f"{self.seed}:{self.vendor}"
            u = _hash_units(f"{miss_salt}:miss:{type_name}:{az}:{int(t)}", 1)[0]
            if u < self._missing_rate:
                return None
        f = self.free(t, np.array([self._pool_idx(type_name, region, az)]))[0]
        if f >= n:
            return 3
        if f >= np.ceil(n / 2):
            return 2
        return 1

    def t3_true(self, type_name: str, region: str, az: str, *,
                t: float | None = None, cap: int = SPS_CAP) -> int:
        t = self.now if t is None else t
        f = self.free(t, np.array([self._pool_idx(type_name, region, az)]))[0]
        return int(np.clip(np.floor(f), 0, cap))

    def request_spot(self, type_name: str, region: str, az: str, n: int, *,
                     launch: bool = True) -> tuple[bool, list[int]]:
        """Spot request at the current market time.  Success iff free >= n."""
        i = self._pool_idx(type_name, region, az)
        f = self.free(self.now, np.array([i]))[0]
        if f < n:
            return False, []
        if not launch:
            return True, []
        ids = []
        for _ in range(n):
            nid = len(self._records)
            self._records.append(NodeRecord(nid, i, self.now))
            self._alive_by_pool.setdefault(i, []).append(nid)
            ids.append(nid)
        self._used[i] += n
        return True, ids

    def terminate(self, node_ids: list[int]) -> None:
        for nid in node_ids:
            rec = self._records[nid]
            if rec.alive:
                rec.end_t = self.now
                rec.reason = "terminated"
                self._used[rec.pool_idx] -= 1
                self._alive_by_pool[rec.pool_idx].remove(nid)

    def node(self, node_id: int) -> NodeRecord:
        """The (live, mutable) record of one launched node."""
        return self._records[node_id]

    # ------------------------------------------------------------------
    # time + interruptions
    # ------------------------------------------------------------------

    def advance(self, to_t: float, check_every: float = 5.0) -> list[NodeRecord]:
        """Advance market time, reclaiming nodes when capacity drops.

        Returns the interruption events emitted during the advance.
        """
        events: list[NodeRecord] = []
        t = self.now
        while t < to_t:
            t = min(t + check_every, to_t)
            active = [i for i, ids in self._alive_by_pool.items() if ids]
            if not active:
                continue
            idx = np.array(active)
            cap = self.capacity(t, idx)
            for pool_i, c in zip(active, cap):
                excess = int(np.ceil(self._used[pool_i] - c))
                if excess <= 0:
                    continue
                alive = self._alive_by_pool[pool_i]
                victims = self._rng.choice(len(alive), size=min(excess, len(alive)),
                                           replace=False)
                victim_ids = [alive[v] for v in sorted(victims, reverse=True)]
                for nid in victim_ids:
                    rec = self._records[nid]
                    rec.end_t = t
                    rec.reason = "interrupted"
                    alive.remove(nid)
                    self._used[pool_i] -= 1
                    events.append(rec)
        self.now = to_t
        self.interruptions.extend(events)
        return events

    def reclaim(self, type_name: str, region: str, az: str, n: int) -> list[NodeRecord]:
        """Force-interrupt up to ``n`` alive nodes of one capacity pool.

        The chaos-replay hook: targeted interruption injection at the current
        market time, independent of the capacity process (which ``advance``
        already models).  Victims are seeded-random, events land in
        :attr:`interruptions` exactly like capacity-driven reclaims, so the
        operator cannot tell the difference — which is the point.
        """
        i = self._pool_idx(type_name, region, az)
        alive = self._alive_by_pool.get(i, [])
        if not alive or n <= 0:
            return []
        victims = self._rng.choice(len(alive), size=min(n, len(alive)),
                                   replace=False)
        events = []
        for nid in [alive[v] for v in sorted(victims, reverse=True)]:
            rec = self._records[nid]
            rec.end_t = self.now
            rec.reason = "interrupted"
            alive.remove(nid)
            self._used[i] -= 1
            events.append(rec)
        self.interruptions.extend(events)
        return events

    def events_since(self, cursor: int) -> tuple[list[NodeRecord], int]:
        """Interruption events after ``cursor``; returns (events, new cursor)."""
        return self.interruptions[cursor:], len(self.interruptions)

    # ------------------------------------------------------------------
    # derived vendor metrics
    # ------------------------------------------------------------------

    def interruption_free_score(self, type_name: str, region: str, *,
                                t: float | None = None) -> int:
        """AWS 'interruption frequency' bucket mapped to 1-3 (SpotVerse's IF).

        Derived from the pool process itself (churn propensity over the past
        30 days) so it exists without requiring our own launch history,
        mirroring the vendor-published aggregate metric.
        """
        t = self.now if t is None else t
        azs = self.catalog.azs(region)
        idx = np.array([self._pool_idx(type_name, region, az) for az in azs])
        # sample the past 30 days at 6h resolution
        ts = np.arange(max(0.0, t - 30 * MINUTES_PER_DAY), t + 1, 360.0)
        caps = np.stack([self.capacity(tt, idx) for tt in ts])  # (T, A)
        mean = caps.mean(0)
        drop = (np.minimum.accumulate(caps[::-1], 0)[::-1] < 0.5 * mean).mean(0)
        churn = float(drop.mean())
        if churn < 0.05:
            return 3
        if churn < 0.20:
            return 2
        return 1

    @property
    def records(self) -> list[NodeRecord]:
        return self._records
