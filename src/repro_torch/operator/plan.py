"""Phased migration plans: clusterman-style diversified refill.

A risk trigger never swaps a pool wholesale.  :func:`build_migration_plan`
diffs the pool's *alive* membership against the fresh recommendation and
emits an ordered list of :class:`MigrationPhase` steps, each bounded by
``max_concurrent_replacements`` node moves, each launching before it
retires, and none allowed to drain the pool below the quorum floor —
capacity-ordered brain surgery, not a restart.

Launch ordering follows the diversified-refill idiom: capacity pools
**uncorrelated** with the interruptions that triggered the plan (no shared
(family, az) with a recently-reclaimed member) come first, then smallest
deficit first (spread across markets instead of piling into one), cheaper
first on ties.  Retirements drain the most-surplus, lowest-scoring markets
first.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.types import Recommendation, ResourceRequest
from .cmdb import TrackedPool

Key = tuple  # (type_name, region, az)


@dataclass
class MigrationPhase:
    """One bounded step: launches first, then retirements."""

    launches: list[tuple[Key, int]] = field(default_factory=list)
    retire_node_ids: list[int] = field(default_factory=list)

    @property
    def moves(self) -> int:
        return sum(n for _, n in self.launches) + len(self.retire_node_ids)


@dataclass
class MigrationPlan:
    """The phased path from the current roster to the fresh recommendation."""

    pool_id: int
    created_t: float
    reason: str
    phases: list[MigrationPhase]
    executed_phases: int = 0

    @property
    def done(self) -> bool:
        return self.executed_phases >= len(self.phases)

    @property
    def next_phase(self) -> MigrationPhase | None:
        return None if self.done else self.phases[self.executed_phases]

    @property
    def total_moves(self) -> int:
        return sum(p.moves for p in self.phases)


def _desired_counts(rec: Recommendation) -> dict[Key, int]:
    out: dict[Key, int] = {}
    for ty, rg, az, n in zip(rec.names, rec.regions, rec.azs, rec.counts):
        key = (str(ty), str(rg), str(az))
        out[key] = out.get(key, 0) + int(n)
    return out


def build_migration_plan(pool: TrackedPool, target: Recommendation, *,
                         now: float, reason: str,
                         max_concurrent_replacements: int,
                         quorum_floor: float, catalog,
                         correlated: set[tuple[str, str]] = frozenset(),
                         scores: dict[Key, float] | None = None,
                         ) -> MigrationPlan | None:
    """Diff alive membership against ``target``; phase the moves.

    ``correlated`` is the set of (family, az) pairs implicated in recent
    interruptions — deficits in uncorrelated markets are scheduled ahead of
    them.  ``scores`` (current availability score per key, when known)
    orders retirements lowest-score-first.  Returns ``None`` when the
    roster already matches the target.
    """
    desired = _desired_counts(target)
    alive = pool.alive_by_key()
    use_cpus = pool.request.cpus is not None
    cap_of = lambda key: (catalog.get(key[0]).vcpus if use_cpus  # noqa: E731
                          else catalog.get(key[0]).memory_gb)

    deficits = {k: n - alive.get(k, 0) for k, n in desired.items()
                if n > alive.get(k, 0)}
    surplus = {k: n - desired.get(k, 0) for k, n in alive.items()
               if n > desired.get(k, 0)}
    if not deficits and not surplus:
        return None

    def is_correlated(key: Key) -> bool:
        return (catalog.get(key[0]).family, key[2]) in correlated

    # -- launch queue: uncorrelated first, smallest deficit first, cheap ties
    launch_keys = sorted(
        deficits,
        key=lambda k: (is_correlated(k), deficits[k],
                       catalog.spot_price(k[0], k[1])))
    launch_queue: list[Key] = []
    for k in launch_keys:
        launch_queue.extend([k] * deficits[k])

    # -- retire queue: most surplus first, lowest current score first
    retire_keys = sorted(
        surplus,
        key=lambda k: (-surplus[k],
                       (scores or {}).get(k, 0.0)))
    retire_queue: list[int] = []
    for k in retire_keys:
        members = sorted((m for m in pool.alive_members if m.key == k),
                         key=lambda m: m.launch_t)
        retire_queue.extend(m.node_id for m in members[:surplus[k]])

    # -- phase the moves: launches lead, retirements follow, and a phase's
    # retirements never take the *post-launch* roster below the quorum floor
    # (the executor re-checks against the actual roster at execution time —
    # a failed launch defers the retirement, it does not waive the floor).
    floor_cap = quorum_floor * pool.amount
    projected = dict(alive)
    node_key = {m.node_id: m.key for m in pool.alive_members}
    phases: list[MigrationPhase] = []
    li = ri = 0
    while li < len(launch_queue) or ri < len(retire_queue):
        phase = MigrationPhase()
        budget = max_concurrent_replacements
        while budget > 0 and li < len(launch_queue):
            k = launch_queue[li]
            if phase.launches and phase.launches[-1][0] == k:
                phase.launches[-1] = (k, phase.launches[-1][1] + 1)
            else:
                phase.launches.append((k, 1))
            projected[k] = projected.get(k, 0) + 1
            li += 1
            budget -= 1
        proj_cap = sum(n * cap_of(k) for k, n in projected.items())
        while budget > 0 and ri < len(retire_queue):
            nid = retire_queue[ri]
            k = node_key[nid]
            if proj_cap - cap_of(k) < floor_cap:
                break               # next phase's launches restore headroom
            phase.retire_node_ids.append(nid)
            projected[k] -= 1
            proj_cap -= cap_of(k)
            ri += 1
            budget -= 1
        if phase.moves == 0:
            # nothing schedulable this round: retirements blocked on the
            # floor with no launches left to raise it — stop rather than spin
            break
        phases.append(phase)

    if not phases:
        return None
    return MigrationPlan(pool_id=pool.pool_id, created_t=now,
                         reason=reason, phases=phases)
