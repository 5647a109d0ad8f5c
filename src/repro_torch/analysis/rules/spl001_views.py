"""SPL001 — a view read after the in-place write of its base.

The reference's SPL001 guards a donated ring buffer: a read of the buffer
folded into the dispatch that writes it in place.  Eager PyTorch has the
same hazard in another form: basic indexing returns a **view**, and an
in-place write of the base shows through every view of it.
``RollingDeviceArchive.append`` binds ``y_old = self._buf[slot]`` (the
column about to be evicted), hands it to the statistics update (kernel B3)
and only then writes ``self._buf[slot] = codes``.  A read of ``y_old`` after
that write sees the new column, not the evicted one, and the streaming
moments drift without an error.

The rule, inside one function body (nested functions are checked on their
own):

- a *view* is a name bound directly to a basic-index subscript of a plain
  chain (``self._buf[slot]``, ``buf[:, k]``), or to a conditional
  expression with such a branch; anything in between (``.clone()``,
  ``.copy()``, ``.to(...)``, arithmetic) makes a new tensor, and an index
  holding a list, a comparison or a call other than ``int`` / ``len`` /
  ``min`` / ``max`` / ``slice`` is advanced indexing, which copies;
- an *in-place write* of the base is a subscript (or augmented) assignment
  to it, an augmented assignment to the base itself, or a call of an
  in-place method (``copy_``, ``index_copy_``, ``fill_``, ``zero_``, any
  method whose name ends in one ``_``) on it or on a subscript of it;
- a view may not be loaded in a statement after such a write in lexical
  order, unless the name (or the base) was rebound in between.

A write at one index reaches the views taken at the same index expression
(``y_old = self._buf[slot]`` and ``self._buf[slot] = codes``); a write of
the whole base, or of a range (an index holding a slice or ``...``), and
a view of a range meet every write of their base.  Two different index
expressions that happen to be equal at run time are not seen: the rule
reads the source, not the values.

Writing through the view itself (``y.copy_(...)``) is not a write of the
base for this rule: reading ``y`` after it is what the caller asked for.
"""
from __future__ import annotations

import ast

from ..framework import FileContext, Rule, register
from . import _ast_util as U

#: calls that may appear in a basic index (they return Python ints/slices)
_INDEX_CALLS = frozenset({"int", "len", "min", "max", "slice"})


def _basic_index(node: ast.expr) -> bool:
    """True when a subscript's slice is basic indexing (a view)."""
    for sub in ast.walk(node):
        if isinstance(sub, (ast.List, ast.ListComp, ast.Set, ast.Dict,
                            ast.Compare, ast.GeneratorExp)):
            return False
        if isinstance(sub, ast.Call) and not (
                isinstance(sub.func, ast.Name)
                and sub.func.id in _INDEX_CALLS):
            return False
    return True


def _region(sub: ast.Subscript | None) -> str | None:
    """What part of its base a subscript covers: the index expression's
    dump for one index, ``None`` for a range or the whole base."""
    if sub is None or any(isinstance(n, ast.Slice) or (
            isinstance(n, ast.Constant) and n.value is Ellipsis)
            for n in ast.walk(sub.slice)):
        return None
    return ast.dump(sub.slice)


def _meet(a: str | None, b: str | None) -> bool:
    return a is None or b is None or a == b


def _views_of(value: ast.expr) -> set[tuple[str, str | None]]:
    """``(base, region)`` of every view a bound value may be."""
    if isinstance(value, ast.IfExp):
        return _views_of(value.body) | _views_of(value.orelse)
    if isinstance(value, ast.Subscript) and _basic_index(value.slice):
        key = U.expr_key(value.value)
        if key is not None:
            return {(key, _region(value))}
    return set()


def _in_place_method(name: str) -> bool:
    return name.endswith("_") and not name.endswith("__")


def _writes(stmt: ast.stmt) -> set[tuple[str, str | None]]:
    """``(base, region)`` of every in-place write in ``stmt``."""
    out: set[tuple[str, str | None]] = set()
    if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        for t in U.assign_target_exprs(stmt):
            if isinstance(t, ast.Subscript):
                key = U.expr_key(t.value)
                if key is not None:
                    out.add((key, _region(t)))
            elif isinstance(stmt, ast.AugAssign):
                key = U.expr_key(t)
                if key is not None:
                    out.add((key, None))
    for node in _own_nodes(stmt):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and _in_place_method(node.func.attr)):
            recv = node.func.value
            sub = recv if isinstance(recv, ast.Subscript) else None
            key = U.expr_key(sub.value if sub is not None else recv)
            if key is not None:
                out.add((key, _region(sub)))
    return out


def _own_nodes(stmt: ast.stmt):
    """The nodes of ``stmt`` itself: not those of statements nested in it
    (they are visited in their own turn), nor of nested scopes."""
    todo = [stmt]
    while todo:
        node = todo.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.stmt, ast.Lambda)):
                continue
            todo.append(child)


def _statements(body: list[ast.stmt]):
    """Statements in lexical order, not entering nested scopes."""
    for stmt in body:
        yield stmt
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        for name in ("body", "orelse", "finalbody"):
            yield from _statements(getattr(stmt, name, None) or [])
        for h in getattr(stmt, "handlers", None) or []:
            yield from _statements(h.body)


def _rebound(stmt: ast.stmt) -> set[str]:
    """Keys a statement rebinds wholesale (plain assignment, loop target)."""
    out: set[str] = set()
    if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
        for t in U.assign_target_exprs(stmt):
            key = U.expr_key(t)
            if key is not None:
                out.add(key)
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        for node in ast.walk(stmt.target):
            key = U.expr_key(node) if isinstance(node, ast.Name) else None
            if key is not None:
                out.add(key)
    return out


@register
class ViewReadAfterWrite(Rule):
    rule_id = "SPL001"
    title = "view read after an in-place write of its base"
    rationale = ("a basic-index view of a ring slot read after the slot's "
                 "in-place write sees the new column: the evicted one is "
                 "gone and the streaming moments drift")
    scope = ("src/repro_torch/",)

    def check(self, ctx: FileContext):
        for fn in U.functions_in(ctx.tree):
            yield from self._check_function(ctx, fn)

    def _check_function(self, ctx: FileContext, fn):
        views: dict[str, tuple[set, int]] = {}     # name -> (views, line)
        dirty: dict[str, tuple[str, int]] = {}     # view -> (base, write)
        for stmt in _statements(fn.body):
            for node in _own_nodes(stmt):
                if (isinstance(node, ast.Name)
                        and isinstance(node.ctx, ast.Load)
                        and node.id in dirty):
                    base, write = dirty[node.id]
                    yield ctx.finding(
                        node, self,
                        f"`{node.id}` is a view of `{base}` (line "
                        f"{views[node.id][1]}) read after `{base}` was "
                        f"written in place on line {write}: it now holds "
                        f"the new values; read it before the write, or "
                        f"clone it")
                    del dirty[node.id]      # one finding per write
            for key in _rebound(stmt):
                views.pop(key, None)
                dirty.pop(key, None)
                for name in [n for n, (v, _) in views.items()
                             if any(base == key for base, _ in v)]:
                    del views[name]
                    dirty.pop(name, None)
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                of = _views_of(stmt.value)
                if of:
                    views[stmt.targets[0].id] = (of, stmt.lineno)
            for base, region in _writes(stmt):
                for name, (of, _) in views.items():
                    if name not in dirty and any(
                            b == base and _meet(r, region) for b, r in of):
                        dirty[name] = (base, stmt.lineno)
