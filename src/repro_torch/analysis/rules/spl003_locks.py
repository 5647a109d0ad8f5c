"""SPL003 — lock discipline on shared stats / CMDB state.

Carried over from ``repro.analysis.rules.spl003_locks``: the same
annotation map, the same mutator set, the same findings on the same
source.  ``ServeStats`` and ``AdmissionStats`` are reached concurrently by
the admission worker thread, direct callers, the operator and the ingest
pump; an unsynchronized ``+=`` silently drops increments.  Every such
mutation sits under its owner's lock, and this rule keeps it there, seeded
from an annotation map of guarded fields per owner class.  The map is
keyed by class name, so it checks the port's ``BatchServer``,
``AdmissionQueue``, ``IngestPump``, ``PoolCMDB`` and
``FaultInjectedServer`` as it does the reference's.

A write is any assignment (plain, augmented, or subscript) to a chain
rooted at ``self.<guarded-field>``, or a call of a known mutator method on
such a chain (``self.stats.record(...)``, ``self.stats.latency.record(...)``).
It must sit lexically inside a ``with`` block whose context expression is
``self.<one of the class's locks>`` (a ``threading.Condition`` sharing the
lock counts — ``with self._wake`` guards the same mutex).  ``__init__`` is
exempt: construction happens before the object is shared.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass

from ..framework import FileContext, Rule, register
from . import _ast_util as U


@dataclass(frozen=True)
class Guard:
    locks: tuple[str, ...]
    fields: tuple[str, ...]


#: the annotation map: owner class -> (lock attributes, guarded fields):
#: the serving and admission counters, the ingest pump's and the chaos
#: proxy's counters, and the CMDB store shared between the reconcile thread
#: and direct callers.
LOCK_MAP: dict[str, Guard] = {
    "BatchServer": Guard(locks=("_stats_lock",), fields=("stats",)),
    "AdmissionQueue": Guard(locks=("_lock", "_wake"),
                            fields=("stats", "_pending")),
    "PoolCMDB": Guard(locks=("_lock",),
                      fields=("pools", "_by_sig", "_next_id")),
    "IngestPump": Guard(locks=("_stats_lock",),
                        fields=("errors", "last_error", "ticks_pumped")),
    "FaultInjectedServer": Guard(locks=("_inject_lock",),
                                 fields=("injected_failures",)),
}

#: method names that mutate their receiver (reads are never flagged)
MUTATORS = frozenset({
    "record", "record_drain", "record_issued", "merge",
    "append", "extend", "insert", "pop", "popitem", "clear", "remove",
    "add", "discard", "update", "setdefault", "move_to_end",
})

_EXEMPT_METHODS = frozenset({"__init__", "__post_init__"})


def _mutator_chain_field(call: ast.Call) -> str | None:
    """guarded-candidate ``self.<field>`` root of ``self.f...mutator(...)``."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in MUTATORS:
        return U.self_field_of(f)
    return None


@register
class LockDiscipline(Rule):
    rule_id = "SPL003"
    title = "lock discipline (guarded stats/CMDB writes outside their lock)"
    rationale = ("ServeStats/AdmissionStats are mutated from worker "
                 "threads and direct callers; an off-lock += drops updates")
    scope = None        # map-driven: only fires inside the mapped classes

    def check(self, ctx: FileContext):
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef) or cls.name not in LOCK_MAP:
                continue
            guard = LOCK_MAP[cls.name]
            for m in cls.body:
                if not isinstance(m, ast.FunctionDef) \
                        or m.name in _EXEMPT_METHODS:
                    continue
                yield from self._check_method(ctx, cls, m, guard)

    def _check_method(self, ctx: FileContext, cls: ast.ClassDef,
                      m: ast.FunctionDef, guard: Guard):
        for stmt in U.walk_statements(m.body):
            hits: list[tuple[ast.AST, str]] = []
            if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                for t in U.assign_target_exprs(stmt):
                    field = U.self_field_of(t)
                    if field in guard.fields:
                        hits.append((stmt, field))
            if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
                field = _mutator_chain_field(stmt.value)
                if field in guard.fields:
                    hits.append((stmt, field))
            for node, field in hits:
                if self._under_lock(m, stmt, guard):
                    continue
                locks = " / ".join(f"self.{k}" for k in guard.locks)
                yield ctx.finding(
                    node, self,
                    f"{cls.name}.{m.name} writes guarded field "
                    f"`self.{field}` outside `with {locks}` — concurrent "
                    f"writers drop updates (lock discipline)")

    @staticmethod
    def _under_lock(m: ast.FunctionDef, stmt: ast.stmt, guard: Guard) -> bool:
        for expr in U.enclosing_with_exprs(m, stmt):
            field = U.self_field_of(expr)
            if field in guard.locks:
                return True
        return False
