"""The reconcile loop: ingest, observe, assess, migrate — forever.

:class:`Operator` closes the loop the rest of the repo leaves open.  One
:meth:`reconcile_once` cycle:

1. **Ingest** — drive the collector (optional ``collect`` callable) and
   :meth:`~repro_torch.stream.LiveIngestor.poll` under bounded retry with
   exponential backoff and seeded jitter.  A transient fault retries; an
   exhausted budget marks the served archive stale
   (:class:`StaleArchiveWarning`, once per outage streak) and the cycle
   *continues* — old scores beat a dead loop.
2. **Observe** — :meth:`~repro_torch.operator.cmdb.PoolCMDB.sync` re-reads every
   tracked node from the market; interruptions update the correlated
   (family, az) set that steers diversified refill away from blast radii.
3. **Assess** — one O(K) ``score_archive`` dispatch refreshes per-key
   availability scores; each tracked pool gets a survival-backed (or
   heuristic) predicted availability over the horizon
   (``operator.risk``).  Past the threshold — or already under target —
   the pool is re-recommended through the serving stack and, if active, a
   phased migration plan is built (``operator.plan``).
4. **Migrate** — at most one pending phase per pool per cycle executes:
   launches first (node by node, partial fills retried next cycle), then
   retirements, re-checked against the quorum floor at execution time.

:meth:`run` iterates cycles inline (simulation / replay); :meth:`start`
spins the same loop on a daemon thread with a wall-clock period.
"""
from __future__ import annotations

import threading
import time
import warnings
from dataclasses import dataclass, field

import numpy as np

from ..core.types import ResourceRequest
from .cmdb import PoolCMDB, TrackedPool
from .plan import MigrationPlan, build_migration_plan
from .risk import archive_scores, assess_pool, fit_from_cmdb


class StaleArchiveWarning(UserWarning):
    """The reconcile loop's ingest retries are exhausted; serving continues
    on the last good archive version until the feed recovers."""


@dataclass(frozen=True)
class OperatorConfig:
    """Every knob of the reconcile loop, frozen like ``EngineConfig``.

    Parameters
    ----------
    horizon_min : float
        Look-ahead of the eviction-risk estimate (market minutes).
    risk_threshold : float
        Re-recommendation trigger: predicted pool availability below this
        fraction of the requested amount starts a migration.
    min_fit_events : int
        Observed interruptions required before the Cox/KM survival model
        replaces the score-proportional heuristic.
    max_concurrent_replacements : int
        Node moves (launches + retirements) per migration phase.
    quorum_floor : float
        Fraction of the requested amount a migration may never drain the
        alive roster below.
    max_retries : int
        Ingest attempts per cycle beyond the first.
    backoff_base_s, backoff_factor, backoff_jitter : float
        Exponential-backoff schedule between ingest retries: sleep
        ``base * factor**attempt``, scaled by ``1 ± jitter`` (seeded —
        deterministic in replays, decorrelated across real deployments).
    cooldown_cycles : int
        Minimum cycles between successive re-recommendations of one pool —
        a freshly planned migration gets to finish before being replanned.
    period_s : float
        Wall-clock reconcile period for the daemon mode (:meth:`start`).
    seed : int
        Jitter RNG seed.
    """

    horizon_min: float = 60.0
    risk_threshold: float = 0.85
    min_fit_events: int = 8
    max_concurrent_replacements: int = 4
    quorum_floor: float = 0.5
    max_retries: int = 3
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_jitter: float = 0.25
    cooldown_cycles: int = 1
    period_s: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if not 0.0 < self.risk_threshold <= 1.0:
            raise ValueError("risk_threshold must be in (0, 1]")
        if not 0.0 <= self.quorum_floor < 1.0:
            raise ValueError("quorum_floor must be in [0, 1)")
        if self.max_concurrent_replacements < 1:
            raise ValueError("max_concurrent_replacements must be >= 1")
        if self.max_retries < 0 or self.backoff_base_s < 0:
            raise ValueError("retry/backoff knobs must be >= 0")


@dataclass
class OperatorStats:
    cycles: int = 0
    ingest_failures: int = 0        # individual failed attempts
    stale_cycles: int = 0           # cycles that exhausted the retry budget
    interruptions_observed: int = 0
    rerecommendations: int = 0
    migrations_planned: int = 0
    phases_executed: int = 0
    launches: int = 0
    launch_failures: int = 0
    retirements: int = 0
    risk_triggers: dict = field(default_factory=dict)   # reason -> count


class Operator:
    """The closed-loop reconciler over one serving stack and one market.

    Parameters
    ----------
    server : BatchServer
        The serving stack; its ``result_sink`` is claimed by this operator
        so every recommendation served anywhere registers in the CMDB.
    ingestor : LiveIngestor
        The live feed (must be primed before the first cycle).
    market : SpotMarket
        Ground truth for node liveness and the launch/terminate surface.
    config : OperatorConfig, optional
    collect : callable, optional
        Zero-arg collector driver invoked before each ``poll`` (e.g.
        ``collector.collect_once``) — in production the collector runs on
        its own cadence and this is ``None``; simulations and the chaos
        replay drive collection through the operator so injected faults
        land inside the retry envelope.
    sleep : callable
        Backoff sleep (injectable: replays pass a virtual no-op).
    """

    def __init__(self, server, ingestor, market, *,
                 config: OperatorConfig | None = None, collect=None,
                 sleep=time.sleep):
        self.server = server
        self.ingestor = ingestor
        self.market = market
        self.cfg = config or OperatorConfig()
        self.collect = collect
        self.cmdb = PoolCMDB(market.catalog)
        self.stats = OperatorStats()
        self.survival_model = None
        self._sleep = sleep
        self._rng = np.random.default_rng(self.cfg.seed ^ 0x09E5A7)
        self._scores: dict = {}     # last cycle's per-key availability scores
        self._correlated: dict[tuple[str, str], int] = {}  # (family, az) -> cycle
        self._stale_streak = False
        self._worker: threading.Thread | None = None
        self._stop = threading.Event()
        server.result_sink = self._record_issued

    # -- registration ------------------------------------------------------

    def _record_issued(self, request, rec) -> None:
        self.cmdb.record_issued(request, rec, now=self.market.now)

    def launch(self, request: ResourceRequest, rec=None) -> TrackedPool:
        """Serve (if needed) and launch a pool; returns its tracked record.

        Launches node by node so a partially available capacity pool fills
        as far as the market allows — the shortfall shows up as a
        sub-target roster and the very next reconcile cycle starts
        migrating it, which is the honest behaviour under scarcity.
        """
        if rec is None:
            rec = self.server.serve(self.ingestor.archive, [request])[0]
        pool = self.cmdb.record_issued(request, rec, now=self.market.now)
        launched = []
        for ty, rg, az, n, score in zip(rec.names, rec.regions, rec.azs,
                                        rec.counts, rec.availability):
            for _ in range(int(n)):
                ok, ids = self.market.request_spot(str(ty), str(rg),
                                                   str(az), 1)
                if not ok:
                    self.stats.launch_failures += 1
                    continue
                self.stats.launches += 1
                launched.append((ids[0], str(ty), str(rg), str(az),
                                 float(score)))
        self.cmdb.adopt(pool, launched, now=self.market.now)
        return pool

    # -- step 1: ingest with bounded retry + backoff -----------------------

    def _ingest(self) -> bool:
        """Collect + poll under the retry envelope; False = went stale."""
        delay = self.cfg.backoff_base_s
        for attempt in range(self.cfg.max_retries + 1):
            try:
                if self.collect is not None:
                    self.collect()
                self.ingestor.poll()
            except Exception:  # noqa: BLE001 — any feed fault degrades, never kills
                self.stats.ingest_failures += 1
                if attempt == self.cfg.max_retries:
                    break
                jitter = 1.0 + self.cfg.backoff_jitter * float(
                    self._rng.uniform(-1.0, 1.0))
                self._sleep(delay * jitter)
                delay *= self.cfg.backoff_factor
            else:
                self._stale_streak = False
                return True
        self.stats.stale_cycles += 1
        self.ingestor.mark_stale()
        if not self._stale_streak:      # warn once per outage streak
            self._stale_streak = True
            warnings.warn(
                "collector/ingest retries exhausted; serving continues on "
                f"stale archive version {self.ingestor.version}",
                StaleArchiveWarning, stacklevel=3)
        return False

    # -- the cycle ---------------------------------------------------------

    def reconcile_once(self) -> OperatorStats:
        cycle = self.stats.cycles
        self.stats.cycles += 1
        self._ingest()

        # observe: reconcile tracked nodes against the market
        deaths = self.cmdb.sync(self.market)
        for pid, members in deaths.items():
            for m in members:
                if m.reason == "interrupted":
                    self.stats.interruptions_observed += 1
                    self._correlated[(self.market.catalog.get(
                        m.type_name).family, m.az)] = cycle

        # assess: fresh scores + survival model off lived history
        scores = self._scores = archive_scores(self.server.engine,
                                               self.ingestor.archive)
        self.survival_model = fit_from_cmdb(
            self.cmdb, now=self.market.now,
            min_events=self.cfg.min_fit_events) or self.survival_model
        for pool in list(self.cmdb.pools.values()):
            risk = assess_pool(
                pool, scores, model=self.survival_model,
                horizon=self.cfg.horizon_min, now=self.market.now,
                risk_threshold=self.cfg.risk_threshold)
            if not risk.triggered:
                continue
            if cycle - pool.last_action_cycle < self.cfg.cooldown_cycles:
                continue
            if pool.plan is not None and not pool.plan.done:
                continue            # finish the in-flight migration first
            self._re_recommend(pool, cycle, risk.reason, scores)

        # migrate: one phase per migrating pool per cycle
        for pool in self.cmdb.active_pools:
            if pool.plan is not None and not pool.plan.done:
                self._execute_phase(pool)
        return self.stats

    def _re_recommend(self, pool: TrackedPool, cycle: int, reason: str,
                      scores) -> None:
        """Fresh recommendation for a triggered pool; plan the migration."""
        rec = self.server.serve(self.ingestor.archive, [pool.request])[0]
        # (result_sink already refreshed pool.recommendation with `rec`)
        self.stats.rerecommendations += 1
        self.stats.risk_triggers[reason] = \
            self.stats.risk_triggers.get(reason, 0) + 1
        pool.last_action_cycle = cycle
        if not pool.active:
            return                  # issued-only: the refreshed rec is the fix
        correlated = {k for k, c in self._correlated.items()
                      if cycle - c <= 3}
        plan = build_migration_plan(
            pool, rec, now=self.market.now, reason=reason,
            max_concurrent_replacements=self.cfg.max_concurrent_replacements,
            quorum_floor=self.cfg.quorum_floor,
            catalog=self.market.catalog, correlated=correlated,
            scores=scores)
        if plan is not None:
            pool.plan = plan
            self.stats.migrations_planned += 1

    def _execute_phase(self, pool: TrackedPool) -> None:
        plan: MigrationPlan = pool.plan
        phase = plan.next_phase
        launched = []
        all_filled = True
        for (ty, rg, az), n in phase.launches:
            for _ in range(n):
                ok, ids = self.market.request_spot(ty, rg, az, 1)
                if not ok:
                    self.stats.launch_failures += 1
                    all_filled = False
                    continue
                self.stats.launches += 1
                launched.append((ids[0], ty, rg, az,
                                 self._scores.get((ty, rg, az), 0.0)))
        if launched:
            self.cmdb.adopt(pool, launched, now=self.market.now)
        # retire only down to the floor, measured on the *actual* roster —
        # failed launches shrink what this phase may drain
        floor_cap = self.cfg.quorum_floor * pool.amount
        for nid in phase.retire_node_ids:
            m = pool.members.get(nid)
            if m is None or not m.alive:
                continue            # the market beat us to it
            if pool.alive_capacity - m.capacity < floor_cap:
                all_filled = False  # floor reached: defer to a replan
                break
            self.market.terminate([nid])
            m.end_t = self.market.now
            m.reason = "terminated"
            self.stats.retirements += 1
        self.stats.phases_executed += 1
        if all_filled:
            plan.executed_phases += 1
            if plan.done:
                pool.plan = None
        else:
            # A shortfall (failed launch, floor-blocked retirement) makes
            # the remaining phases' roster assumptions wrong; retrying the
            # same phase would re-launch its already-filled rows.  Drop the
            # plan — the next cycle re-assesses from the observed roster
            # and replans, which is the reconcile pattern in miniature.
            pool.plan = None

    # -- drivers -----------------------------------------------------------

    def run(self, cycles: int) -> OperatorStats:
        """Reconcile ``cycles`` times inline (simulation / replay mode)."""
        for _ in range(cycles):
            self.reconcile_once()
        return self.stats

    def start(self) -> "Operator":
        """Reconcile every ``config.period_s`` on a daemon thread."""
        if self._worker is not None and self._worker.is_alive():
            return self
        self._stop.clear()
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="operator-reconcile")
        self._worker.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._worker is not None:
            self._worker.join()
            self._worker = None

    @property
    def running(self) -> bool:
        return self._worker is not None and self._worker.is_alive()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.reconcile_once()
            except Exception:  # noqa: BLE001 — the loop must outlive any cycle
                pass
            self._stop.wait(self.cfg.period_s)
