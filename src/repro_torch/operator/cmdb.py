"""Pool state store: every issued recommendation, every launched node.

The reconciler's CMDB (the pg-spot-operator term for exactly this table):
:class:`PoolCMDB` holds one :class:`TrackedPool` per distinct request
signature the serving stack has answered, and — once a pool is *adopted*
(its nodes actually launched) — one :class:`PoolMember` per node with its
full lifetime: launch time, the availability score the member's capacity
pool carried at launch (the Cox covariate), and, when the market reclaims
or the operator retires it, the end time and reason.

Registration is push-based (the engine's ``result_sink`` feeds
:meth:`record_issued` for every recommendation served anywhere in the
stack), but liveness is pull-based: :meth:`sync` re-reads each tracked
node's record from the :class:`~repro_torch.cloudsim.market.SpotMarket` rather
than consuming interruption events — the reconcile pattern.  A missed event
(crashed cycle, delayed tick) therefore cannot desynchronise the store;
the next sync observes the truth.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

from ..core.types import Recommendation, ResourceRequest


@dataclass
class PoolMember:
    """One launched node of a tracked pool — a survival-analysis subject."""

    node_id: int
    type_name: str
    region: str
    az: str
    capacity: float          # vcpus or memory_gb, per the pool's request axis
    launch_t: float          # market minutes
    launch_score: float      # availability score of the capacity pool at launch
    end_t: float | None = None
    reason: str | None = None   # "interrupted" | "terminated"

    @property
    def alive(self) -> bool:
        return self.end_t is None

    @property
    def key(self) -> tuple[str, str, str]:
        return (self.type_name, self.region, self.az)


@dataclass
class TrackedPool:
    """One request signature's pool: issued always, active once adopted."""

    pool_id: int
    request: ResourceRequest
    recommendation: Recommendation
    issued_t: float
    #: capacity-weighted mean AS/100 of the recommended pool at issue time —
    #: the "recommended availability" half of the paper's delivered-vs-
    #: recommended metric.
    recommended_availability: float
    active: bool = False
    members: dict[int, PoolMember] = field(default_factory=dict)
    #: pending phased migration (see ``operator.plan``); None when healthy
    plan: object | None = None
    rerecommendations: int = 0
    last_action_cycle: int = -(1 << 30)
    #: members reclaimed by the market over this pool's whole history
    interrupted_total: int = 0

    @property
    def amount(self) -> float:
        return self.request.amount

    @property
    def alive_members(self) -> list[PoolMember]:
        return [m for m in self.members.values() if m.alive]

    @property
    def alive_capacity(self) -> float:
        return float(sum(m.capacity for m in self.alive_members))

    def delivered_fraction(self) -> float:
        """min(1, alive capacity / requested amount) — the delivered-
        availability sample this pool contributes at any instant."""
        if not self.active:
            return 1.0
        return min(1.0, self.alive_capacity / self.amount)

    def alive_by_key(self) -> dict[tuple[str, str, str], int]:
        out: dict[tuple[str, str, str], int] = {}
        for m in self.alive_members:
            out[m.key] = out.get(m.key, 0) + 1
        return out


def recommended_availability(request: ResourceRequest,
                             rec: Recommendation, catalog) -> float:
    """Capacity-weighted mean AS/100 of a recommendation's pool."""
    caps = np.array([
        (catalog.get(n).vcpus if request.cpus is not None
         else catalog.get(n).memory_gb) for n in rec.names], np.float64)
    w = np.asarray(rec.counts, np.float64) * caps
    if w.sum() <= 0:
        return 0.0
    return float((w * np.asarray(rec.availability, np.float64)).sum()
                 / w.sum() / 100.0)


class PoolCMDB:
    """State store of every pool the stack has recommended or launched."""

    def __init__(self, catalog):
        self.catalog = catalog
        self.pools: dict[int, TrackedPool] = {}
        self._by_sig: dict[tuple, int] = {}
        self._next_id = 0
        # result_sink registration arrives from serving threads while the
        # reconcile loop iterates; RLock because sync() re-enters via the
        # active_pools property.
        self._lock = threading.RLock()

    def __len__(self) -> int:
        with self._lock:
            return len(self.pools)

    @property
    def active_pools(self) -> list[TrackedPool]:
        with self._lock:
            return [p for p in self.pools.values() if p.active]

    @property
    def issued_pools(self) -> list[TrackedPool]:
        with self._lock:
            return [p for p in self.pools.values() if not p.active]

    # -- registration ------------------------------------------------------

    def record_issued(self, request: ResourceRequest, rec: Recommendation,
                      *, now: float) -> TrackedPool:
        """Track one served recommendation (the ``result_sink`` target).

        Deduplicated by ``request.signature()``: a repeat serve of the same
        signature refreshes the stored recommendation (an issued-only pool
        follows the market this way) and counts a re-recommendation when
        the pool was already tracked.  Active pools keep their launched
        membership — the refreshed recommendation is the input their
        migration planning diffs against, not a replacement roster.
        """
        sig = request.signature()
        with self._lock:
            pid = self._by_sig.get(sig)
            if pid is None:
                pool = TrackedPool(
                    pool_id=self._next_id, request=request,
                    recommendation=rec, issued_t=now,
                    recommended_availability=recommended_availability(
                        request, rec, self.catalog))
                self.pools[self._next_id] = pool
                self._by_sig[sig] = self._next_id
                self._next_id += 1
                return pool
            pool = self.pools[pid]
            pool.recommendation = rec
            pool.rerecommendations += 1
            return pool

    def adopt(self, pool: TrackedPool, launched, *, now: float) -> None:
        """Promote an issued pool to active with its launched nodes.

        ``launched`` is ``[(node_id, type_name, region, az, launch_score)]``
        — the operator's launch helper produces it row by row so partial
        fills register exactly what exists.
        """
        use_cpus = pool.request.cpus is not None
        with self._lock:
            for node_id, ty, rg, az, score in launched:
                it = self.catalog.get(ty)
                pool.members[node_id] = PoolMember(
                    node_id=node_id, type_name=ty, region=rg, az=az,
                    capacity=it.vcpus if use_cpus else it.memory_gb,
                    launch_t=now, launch_score=float(score))
            pool.active = True

    # -- reconciliation ----------------------------------------------------

    def sync(self, market) -> dict[int, list[PoolMember]]:
        """Re-read every tracked node from the market; return new deaths.

        For each active pool, each member still marked alive here is
        checked against its live :class:`~repro_torch.cloudsim.market.NodeRecord`
        — end time and reason are copied over when the market says it died.
        Returns ``{pool_id: [members that died since the last sync]}``
        (interrupted *and* cleanly terminated; callers filter by
        ``reason``).
        """
        deaths: dict[int, list[PoolMember]] = {}
        with self._lock:
            for pool in self.active_pools:
                for m in pool.members.values():
                    if not m.alive:
                        continue
                    rec = market.node(m.node_id)
                    if rec.alive:
                        continue
                    m.end_t = rec.end_t
                    m.reason = rec.reason
                    if rec.reason == "interrupted":
                        pool.interrupted_total += 1
                    deaths.setdefault(pool.pool_id, []).append(m)
        return deaths

    # -- survival-analysis feed --------------------------------------------

    def lifetimes(self, now: float):
        """The (x, durations, events) table over every member ever adopted.

        ``x`` is the availability score at launch (the §6.3 covariate),
        ``durations`` the observed lifetime in market minutes, ``events``
        1 for market interruptions and 0 for censored subjects (still
        alive, or retired by the operator itself — an operator-driven
        ``terminate`` says nothing about the market's hazard).
        """
        x, dur, ev = [], [], []
        with self._lock:
            for pool in self.active_pools:
                for m in pool.members.values():
                    x.append(m.launch_score)
                    end = now if m.alive else m.end_t
                    dur.append(max(end - m.launch_t, 1e-9))
                    ev.append((not m.alive) and m.reason == "interrupted")
        return (np.asarray(x, np.float64), np.asarray(dur, np.float64),
                np.asarray(ev, bool))

    def n_interruptions(self) -> int:
        with self._lock:
            return sum(p.interrupted_total for p in self.pools.values())
