"""SPL002 — float32 pins against float64 host inputs.

The reference's SPL002 pins ``jnp`` constructors whose dtype widens under
``jax_enable_x64``.  The port's twin: numpy defaults to float64, and
``torch.tensor`` / ``torch.as_tensor`` / ``torch.from_numpy`` keep their
input's dtype, so a float64 host array silently becomes a float64 tensor.
The kernels and their bit-for-bit plain versions are float32; a float64
operand either fails a kernel's dtype check on the card or, on the CPU,
runs the plain version in float64 and parts from the card's bits.

In the scoped modules (the serving engine's numeric core and the layers
around it) the rule flags:

- ``torch.tensor`` / ``torch.as_tensor`` with no dtype (``dtype=``, or
  ``as_tensor``'s second positional argument);
- ``torch.from_numpy(x)`` with nothing pinning the dtype;
- ``.astype(float)`` / ``.astype("float64")``, as the reference does.

A constructor counts as pinned when it names a dtype, when it is
followed at once by a cast (``.float()``, ``.bool()``, ``.long()``, ...,
``.to(torch.<dtype>)`` or ``.to(..., dtype=...)``), or when its data
argument is a numpy call that names one (``x.astype(np.float32)``,
``np.asarray(x, np.float32)``, ``np.ascontiguousarray(x, dtype=...)``).
Deliberate float64 (the rounded float64 roots, F1's CPU prefix sums) is
written as an explicit ``torch.float64`` and so is pinned too.
"""
from __future__ import annotations

import ast

from ..framework import FileContext, Rule, register

_CONSTRUCTORS = frozenset({"tensor", "as_tensor", "from_numpy"})
#: cast methods that fix the result's dtype whatever the input's
_CASTS = frozenset({"float", "double", "half", "bfloat16", "bool", "int",
                    "long", "short", "byte", "char"})
#: numpy calls whose dtype argument pins the array (positional index)
_NP_DTYPE_POS = {"asarray": 1, "array": 1, "ascontiguousarray": 1,
                 "astype": 0}
#: builtin dtype-ish arguments that mean float64
_WIDENING_NAMES = {"float"}
_WIDENING_STRINGS = {"float", "float64", "f8", "double"}


def _torch_constructor(call: ast.Call) -> str | None:
    f = call.func
    if (isinstance(f, ast.Attribute) and f.attr in _CONSTRUCTORS
            and isinstance(f.value, ast.Name) and f.value.id == "torch"):
        return f.attr
    return None


def _names_dtype(call: ast.Call, pos: int | None) -> bool:
    if any(kw.arg == "dtype" for kw in call.keywords):
        return True
    return pos is not None and len(call.args) > pos


def _is_torch_dtype(node: ast.expr) -> bool:
    return (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "torch")


def _cast_at_once(call: ast.Call, parents: dict) -> bool:
    """``call`` is the receiver of an immediate dtype cast."""
    attr = parents.get(id(call))
    if not (isinstance(attr, ast.Attribute) and attr.value is call):
        return False
    outer = parents.get(id(attr))
    if not (isinstance(outer, ast.Call) and outer.func is attr):
        return False
    if attr.attr in _CASTS:
        return True
    if attr.attr == "to":
        return (any(kw.arg == "dtype" for kw in outer.keywords)
                or any(_is_torch_dtype(a) for a in outer.args))
    return False


def _numpy_pinned(arg: ast.expr) -> bool:
    """``arg`` is a numpy call that names the array's dtype."""
    if not (isinstance(arg, ast.Call) and isinstance(arg.func, ast.Attribute)):
        return False
    name = arg.func.attr
    if name not in _NP_DTYPE_POS:
        return False
    if name != "astype" and not (isinstance(arg.func.value, ast.Name)
                                 and arg.func.value.id in ("np", "numpy")):
        return False
    return _names_dtype(arg, _NP_DTYPE_POS[name])


@register
class Float32Pin(Rule):
    rule_id = "SPL002"
    title = "f32-pin (dtype-inheriting tensor constructors)"
    rationale = ("numpy defaults to float64 and torch.tensor / as_tensor / "
                 "from_numpy keep it: the float32 kernels and their "
                 "bit-for-bit plain versions then see float64")
    scope = tuple(f"src/repro_torch/{d}/" for d in (
        "core", "kernels", "parallel", "stream", "serve", "shard",
        "operator", "multicloud", "loadgen"))

    def check(self, ctx: FileContext):
        parents = {id(child): node for node in ast.walk(ctx.tree)
                   for child in ast.iter_child_nodes(node)}
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            ctor = _torch_constructor(node)
            if ctor is not None:
                pos = 1 if ctor == "as_tensor" else None
                if not (_names_dtype(node, pos)
                        or _cast_at_once(node, parents)
                        or (node.args and _numpy_pinned(node.args[0]))):
                    yield ctx.finding(
                        node, self,
                        f"`torch.{ctor}` without a dtype pin keeps its "
                        f"input's dtype (numpy's float64 by default); pass "
                        f"dtype= (torch.float32 for archive/stats tensors, "
                        f"torch.float64 where it is meant)")
                continue
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "astype" and node.args):
                a = node.args[0]
                if ((isinstance(a, ast.Name) and a.id in _WIDENING_NAMES)
                        or (isinstance(a, ast.Constant)
                            and a.value in _WIDENING_STRINGS)):
                    yield ctx.finding(
                        node, self,
                        "`.astype(float)` is float64; pin an explicit "
                        "width (np.float32)")
