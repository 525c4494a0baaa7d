"""Nested dict/list/tuple parameter trees (the port's stand-in for
``jax.tree``): flatten to a leaf list and back, and map over leaves.

Leaves come out in ``jax.tree.leaves`` order (dict keys sorted, sequences
in order), so a flattened port tree lines up with the JAX package's.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten(tree) -> Tuple[List[Any], Any]:
    """``tree -> (leaves, spec)``; :func:`unflatten` inverts it."""
    leaves: List[Any] = []

    def rec(node):
        if isinstance(node, dict):
            return (dict, tuple((k, rec(node[k])) for k in sorted(node)))
        if isinstance(node, (list, tuple)):
            return (type(node), tuple(rec(v) for v in node))
        leaves.append(node)
        return None

    return leaves, rec(tree)


def unflatten(spec, leaves):
    it = iter(leaves)

    def rec(s):
        if s is None:
            return next(it)
        kind, children = s
        if kind is dict:
            return {k: rec(c) for k, c in children}
        return kind(rec(c) for c in children)

    return rec(spec)


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of trees with one structure."""
    flat, spec = flatten(tree)
    others = [flatten(t)[0] for t in rest]
    return unflatten(spec, [fn(*xs) for xs in zip(flat, *others)])
