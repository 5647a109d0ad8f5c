"""SPL005 — Python control flow on device tensors.

The reference's SPL005 keeps Python ``if`` / ``for`` off traced operands
inside ``jax.jit``: there a tracer raises or the loop silently unrolls
into the graph.  In eager PyTorch the same code runs, at a cost that
nothing reports:

- ``if t.any():`` (or ``while``, or a ternary) copies the value to the
  host, so the host waits for the card to finish everything queued before;
- ``for x in t:`` launches one indexing op per element, the eager form of
  the unroll.

The rule, scoped to ``kernels/`` and ``core/``: in a function, a branch
test or a loop iterable may not read a parameter annotated as a tensor
(``torch.Tensor``, ``Tensor``, or a union / ``Optional`` holding one).
Exempt are identity tests against ``None`` and host metadata, which never
leaves the host: ``.shape``, ``.ndim``, ``.dim()``, ``.size()``,
``.dtype``, ``.device``, ``.is_cuda``, ``.numel()``, ``.is_contiguous()``,
``.requires_grad``, ``len(t)`` and ``isinstance(t, ...)``.  Nested
functions are checked with their own parameters.

The reference's second pattern (a non-hashable ``static_argnames`` value)
has no PyTorch counterpart: eager calls have no static arguments.
"""
from __future__ import annotations

import ast

from ..framework import FileContext, Rule, register
from . import _ast_util as U

#: tensor attributes that are host metadata (no device read)
_META_ATTRS = frozenset({"shape", "ndim", "dtype", "device", "is_cuda",
                         "requires_grad", "layout"})
#: tensor methods that return host metadata
_META_METHODS = frozenset({"dim", "size", "numel", "is_contiguous",
                           "element_size", "stride"})
#: builtins that read only host metadata of their first argument
_META_BUILTINS = frozenset({"len", "isinstance"})


def _is_tensor_annotation(ann: ast.expr | None) -> bool:
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return False
    for node in ast.walk(ann):
        if isinstance(node, ast.Name) and node.id == "Tensor":
            return True
        if isinstance(node, ast.Attribute) and node.attr == "Tensor":
            return True
    return False


def _tensor_params(fn) -> set[str]:
    a = fn.args
    params = (*a.posonlyargs, *a.args, *a.kwonlyargs)
    return {p.arg for p in params if _is_tensor_annotation(p.annotation)}


def _exempt_names(expr: ast.expr) -> set[int]:
    """ids of Name nodes used only for host metadata or a None identity."""
    out: set[int] = set()
    for node in ast.walk(expr):
        if (isinstance(node, ast.Compare) and len(node.ops) == 1
                and isinstance(node.ops[0], (ast.Is, ast.IsNot))
                and isinstance(node.comparators[0], ast.Constant)
                and node.comparators[0].value is None
                and isinstance(node.left, ast.Name)):
            out.add(id(node.left))
        elif (isinstance(node, ast.Attribute) and node.attr in _META_ATTRS
                and isinstance(node.value, ast.Name)):
            out.add(id(node.value))
        elif isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Attribute) and f.attr in _META_METHODS
                    and isinstance(f.value, ast.Name)):
                out.add(id(f.value))
            elif (isinstance(f, ast.Name) and f.id in _META_BUILTINS
                    and node.args and isinstance(node.args[0], ast.Name)):
                out.add(id(node.args[0]))
    return out


def _own_nodes(fn):
    """Nodes of ``fn``'s body, not entering nested functions or lambdas."""
    todo = list(fn.body)
    while todo:
        node = todo.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda, ast.ClassDef)):
                todo.append(child)


@register
class HostSync(Rule):
    rule_id = "SPL005"
    title = "host control flow on device tensors"
    rationale = ("a Python if on a tensor waits for the card; a for over "
                 "one launches an indexing op per element")
    scope = ("src/repro_torch/kernels/", "src/repro_torch/core/")

    def check(self, ctx: FileContext):
        for fn in U.functions_in(ctx.tree):
            tensors = _tensor_params(fn)
            if not tensors:
                continue
            for node in _own_nodes(fn):
                if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                    yield from self._flag(ctx, node.test, tensors,
                                          kind="branch test")
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    yield from self._flag(ctx, node.iter, tensors,
                                          kind="loop iterable")
                elif isinstance(node, ast.comprehension):
                    yield from self._flag(ctx, node.iter, tensors,
                                          kind="loop iterable")
                    for cond in node.ifs:
                        yield from self._flag(ctx, cond, tensors,
                                              kind="branch test")

    def _flag(self, ctx: FileContext, expr: ast.expr, tensors: set[str], *,
              kind: str):
        exempt = _exempt_names(expr)
        seen: set[str] = set()
        for node in ast.walk(expr):
            if isinstance(node, ast.Lambda):
                return      # closures evaluate later; out of scope
            if (isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load)
                    and node.id in tensors and id(node) not in exempt
                    and node.id not in seen):
                seen.add(node.id)
                yield ctx.finding(
                    node, self,
                    f"Python {kind} on tensor parameter `{node.id}`: on the "
                    f"card it waits for the device (a branch) or launches "
                    f"an op per element (a loop); keep the decision on the "
                    f"device (torch.where) or test host metadata")
