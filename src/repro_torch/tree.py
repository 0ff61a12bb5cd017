"""Nested containers of tensors, flattened in the reference's leaf order.

The parameters, optimizer state and checkpoints are plain nested dicts,
tuples and NamedTuples, as in the JAX package. Their leaves come out in
JAX's pytree order: dict keys sorted, sequences and NamedTuple fields in
order, ``None`` a node without leaves. Four things depend on that order:
the monitor's gradient sketch (one projection per leaf), the clip norm
(a sum over leaves), the checkpoint layout (``leaf_<i>``) and ``convert``.
"""
from __future__ import annotations

from typing import Any, Callable


class _Leaf:
    __slots__ = ()

    def __repr__(self) -> str:
        return "*"


LEAF = _Leaf()


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree: Any) -> tuple[list, Any]:
    """``(leaves, spec)``: the leaves in pytree order, and the tree with
    every leaf replaced by ``LEAF`` (what ``unflatten`` fills back)."""
    leaves: list = []

    def walk(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(walk(x) for x in node))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x) for x in node)
        leaves.append(node)
        return LEAF

    spec = walk(tree)
    del walk    # the closure refers to itself: free the leaves now, not
    return leaves, spec     # at the next cyclic collection


def unflatten(spec: Any, leaves) -> Any:
    """The tree of ``spec`` with its ``LEAF`` marks taken from ``leaves``
    in order."""
    it = iter(leaves)

    def fill(node):
        if node is None:
            return None
        if node is LEAF:
            return next(it)
        if isinstance(node, dict):
            return {k: fill(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(fill(x) for x in node))
        return type(node)(fill(x) for x in node)

    out = fill(spec)
    del fill    # as in ``flatten``: no cycle keeps the leaves alive
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def leaves(tree: Any) -> list:
    return flatten(tree)[0]


def map(fn: Callable, tree: Any, *rest: Any) -> Any:  # noqa: A001
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which must share its structure)."""
    ls, spec = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    for o in others:
        if len(o) != len(ls):
            raise ValueError(f"trees hold {len(ls)} and {len(o)} leaves")
    return unflatten(spec, [fn(*xs) for xs in zip(ls, *others)])
