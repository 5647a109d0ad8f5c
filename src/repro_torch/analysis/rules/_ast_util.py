"""Shared AST plumbing for the port's SPL rules.

The rules reason about the same few shapes — attribute chains rooted at
``self``, assignment targets, lexical statement order and the ``with``
blocks around a statement — so the helpers live here once.  The
reference's ``jax.jit`` parsing has no counterpart: no port rule reads a
jit decoration.
"""
from __future__ import annotations

import ast


def param_names(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> list[str]:
    a = fn.args
    return [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)]


def expr_key(node: ast.expr) -> str | None:
    """Stable key for a pure Name / attribute chain (``self._buf``).

    ``None`` for anything with calls, subscripts, or literals in it — the
    rules only track buffers referenced by plain chains.
    """
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = expr_key(node.value)
        return None if base is None else f"{base}.{node.attr}"
    return None


def self_field_of(node: ast.expr) -> str | None:
    """``'stats'`` for any chain rooted at ``self.stats`` (else ``None``)."""
    chain = node
    prev = None
    while isinstance(chain, (ast.Attribute, ast.Subscript)):
        prev = chain
        chain = chain.value
    if (isinstance(chain, ast.Name) and chain.id == "self"
            and isinstance(prev, ast.Attribute)):
        return prev.attr
    return None


def assign_target_exprs(stmt: ast.stmt) -> list[ast.expr]:
    """Flattened assignment targets of an Assign/AugAssign/AnnAssign."""
    out: list[ast.expr] = []

    def flat(t: ast.expr) -> None:
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                flat(e)
        elif isinstance(t, ast.Starred):
            flat(t.value)
        else:
            out.append(t)

    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            flat(t)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        flat(stmt.target)
    return out


def walk_statements(body: list[ast.stmt]):
    """Depth-first statements in lexical order (source order)."""
    for stmt in body:
        yield stmt
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.stmt):
                # handled via the body lists below
                continue
        for name in ("body", "orelse", "finalbody", "handlers"):
            sub = getattr(stmt, name, None)
            if not sub:
                continue
            if name == "handlers":
                for h in sub:
                    yield from walk_statements(h.body)
            else:
                yield from walk_statements(sub)


def functions_in(tree: ast.AST):
    """Every (async) function definition anywhere in the tree."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def enclosing_with_exprs(fn: ast.AST, target: ast.stmt) -> list[ast.expr]:
    """Context expressions of every ``with`` lexically enclosing ``target``.

    Computed by a parent-tracking walk from ``fn`` (ASTs carry no parent
    links).
    """
    stack: list[ast.expr] = []
    found: list[ast.expr] = []

    def visit(node: ast.AST) -> bool:
        if node is target:
            found.extend(stack)
            return True
        pushed = 0
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                stack.append(item.context_expr)
                pushed += 1
        try:
            for child in ast.iter_child_nodes(node):
                # do not descend into nested function/class scopes
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef)) and child is not target:
                    continue
                if visit(child):
                    return True
        finally:
            for _ in range(pushed):
                stack.pop()
        return False

    visit(fn)
    return found
