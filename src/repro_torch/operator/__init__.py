"""Closed-loop operator: the reconciler that owns issued pools end to end.

The rest of the repo stops at the recommendation boundary — pools are
scored, returned, forgotten.  This package closes the loop the paper's
Tier-1 metric (delivered availability under real interruptions) actually
measures:

- ``cmdb``   — the pool/node state store, fed by the engine's
  ``result_sink`` and reconciled against the market every cycle;
- ``risk``   — §6.3 survival analysis (Cox HR x Kaplan-Meier) turning
  availability-score drift into predicted pool availability;
- ``plan``   — phased, quorum-floored, diversification-aware migration
  plans (the clusterman refill idiom);
- ``loop``   — the reconcile loop itself: backoff-guarded ingest, sync,
  assess, migrate; inline for replays, daemon-threaded for wall clock;
- ``chaos``  — fault-injected replay proving delivered-vs-recommended
  availability under interruptions, collector outages, delayed ticks,
  missing query responses, and failing drains.

PyTorch counterpart of ``repro.operator``: the bookkeeping (CMDB, risk,
plans, the loop and the fault schedule) is the reference's numpy code, line
for line.  The serving stack it drives is the port's, so on the card every
reconcile cycle runs kernel ``stats_update`` once a tick (``poll``),
``score_fuse`` once for the whole archive (``score_archive``), and
``score_fuse`` and ``pool_scan`` for each re-recommendation; the chaos
replay takes ``device=`` (CUDA unless ``"cpu"``).
"""
from .cmdb import PoolCMDB, PoolMember, TrackedPool  # noqa: F401
from .chaos import (ChaosReplay, ChaosSchedule, CollectorOutage,  # noqa: F401
                    FaultInjectedServer, ReplayReport)
from .loop import (Operator, OperatorConfig, OperatorStats,  # noqa: F401
                   StaleArchiveWarning)
from .plan import MigrationPhase, MigrationPlan, build_migration_plan  # noqa: F401
from .risk import PoolRisk, assess_pool, fit_from_cmdb  # noqa: F401
