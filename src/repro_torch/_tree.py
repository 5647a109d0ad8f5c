"""Tree helpers shared by the port: nested dicts, lists, tuples and named
tuples of tensors, the trees JAX's ``tree_util`` walks in the reference.

:func:`tree_flatten` walks leaves in JAX's order (dict keys sorted), the
order optimizer states, checkpoints and the gradient exchange depend on.
The module imports nothing of the port, so the archive tiers and
checkpoints use it without loading the model or training stack.
"""
from __future__ import annotations


def tree_map(f, tree):
    """``f`` over the leaves of nested dicts / lists / tuples and named
    tuples (``None`` stays ``None``)."""
    if isinstance(tree, dict):
        return {k: tree_map(f, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(f, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    if tree is None:
        return None
    return f(tree)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_flatten(tree):
    """``(leaves, rebuild)`` in JAX's order: dict keys sorted, lists and
    tuples in order, ``None`` holding no leaf.  ``rebuild(leaves)`` makes a
    tree of the same layout (and dict key order) from new leaves."""
    leaves: list = []

    def walk(node):
        if isinstance(node, dict):
            index = {k: walk(node[k]) for k in sorted(node)}
            return {k: index[k] for k in node}
        if isinstance(node, (list, tuple)):
            items = [walk(v) for v in node]
            return (type(node)(*items) if hasattr(node, "_fields")
                    else type(node)(items))
        if node is None:
            return None
        leaves.append(node)
        return len(leaves) - 1

    layout = walk(tree)

    def rebuild(new):
        return tree_map(lambda i: new[i], layout)

    return leaves, rebuild
