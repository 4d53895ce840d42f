"""Minimal pytree helpers over tuples, named tuples, lists and dicts of tensors.

Parameters and noise are nested tuples of per-layer dicts, as in the JAX
package, and the engine state is a named tuple of them (with Adam states,
also named tuples); these three helpers are all the port needs to map over
them.
"""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over structurally identical trees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        mapped = (tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
        # a named tuple takes its fields positionally
        return type(tree)(*mapped) if hasattr(tree, "_fields") else type(tree)(mapped)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in the deterministic order ``tree_map`` visits them."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(tree, leaves):
    """Rebuild ``tree``'s structure from ``leaves`` (as ``tree_leaves`` orders them)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
