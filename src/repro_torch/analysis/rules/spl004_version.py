"""SPL004 — version bump on payload mutation (the cache-key contract).

Carried over from ``repro.analysis.rules.spl004_version``, scoped to the
port's archive modules.  The :class:`~repro_torch.serve.ArchiveCache` is
keyed by ``name@vN`` versioned fingerprints, and the whole staleness story
rests on one invariant: *any* method that mutates an archive's payload
(its ring buffer, moment accumulators, cursor, or logical length) must
bump ``self.version`` on the same path, so the stale cache key misses
instead of silently serving a window it no longer describes.  Derived
memos (``_stats``, ``_t3_logical``), flags (``stale``) and the int8 tier's
clip counter (``_clips``, a diagnostic of the encoding, not of the window)
deliberately do *not* bump — the window they describe is unchanged.

The port's versioned classes are ``RollingDeviceArchive``
(``stream/rolling.py``: ``append`` writes ``_buf`` in place by slot,
``_moments``, ``_pos``, ``_len`` and ``appends``) and
``ShardedRollingArchive`` (``shard/archive.py``: ``appends``; its shards'
payload moves through their own ``append``).  No port class mutates a
payload attribute the reference's classes lack, so the set is the same.

The rule: in the archive modules, for every class that versions itself
(assigns ``self.version`` somewhere), each method outside ``__init__`` that
writes a payload attribute must also write ``self.version`` in the same
method body.
"""
from __future__ import annotations

import ast

from ..framework import FileContext, Rule, register
from . import _ast_util as U

#: attributes that ARE the archive payload; mutating any of these changes
#: what the versioned key describes
PAYLOAD_ATTRS = frozenset({"_buf", "_moments", "_pos", "_len", "appends"})


def _method_writes(fn: ast.FunctionDef) -> set[str]:
    """``self.X`` attribute names written anywhere in the method."""
    out: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            for t in U.assign_target_exprs(node):
                field = U.self_field_of(t)
                if field is not None:
                    out.add(field)
    return out


@register
class VersionBump(Rule):
    rule_id = "SPL004"
    title = "cache-key versioning (payload mutation without a version bump)"
    rationale = ("versioned cache keys only keep stale archives out of "
                 "serving if every payload mutation bumps the version")
    scope = ("src/repro_torch/stream/rolling.py",
             "src/repro_torch/serve/archive.py",
             "src/repro_torch/shard/archive.py")

    def check(self, ctx: FileContext):
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            methods = [n for n in cls.body if isinstance(n, ast.FunctionDef)]
            if not any("version" in _method_writes(m) for m in methods):
                continue            # unversioned class: not this contract
            for m in methods:
                if m.name == "__init__":
                    continue
                writes = _method_writes(m)
                touched = sorted(writes & PAYLOAD_ATTRS)
                if touched and "version" not in writes:
                    yield ctx.finding(
                        m, self,
                        f"{cls.name}.{m.name} mutates payload state "
                        f"({', '.join('self.' + a for a in touched)}) "
                        f"without bumping self.version — a stale "
                        f"ArchiveCache key would keep serving the old "
                        f"window")
