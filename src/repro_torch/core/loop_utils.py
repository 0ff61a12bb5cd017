"""Lane freezing for lockstep-batched retrospective loops.

Every adaptive driver advances a NamedTuple of per-lane tensors and must
keep lanes that already resolved their decision *bit-exactly* frozen while
other lanes continue. ``tree_freeze`` is the single implementation of that
rule (counterpart of ``repro.core.loop_utils.tree_freeze``).
"""
from __future__ import annotations

import dataclasses

import torch


def tree_freeze(new, old, frozen: torch.Tensor):
    """Select ``old`` leaves wherever ``frozen`` is True, else ``new``.

    ``new``/``old`` are tensors, ``None``, (named) tuples or frozen
    dataclasses of them with the same structure. ``frozen`` is a bool
    tensor over the lane dims; each leaf may carry extra trailing dims
    (e.g. Lanczos vectors of shape (..., N)), broadcast by appending
    singleton axes.
    """
    if new is None:
        return None
    if isinstance(new, torch.Tensor):
        f = frozen.reshape(frozen.shape + (1,) * (new.ndim - frozen.ndim))
        return torch.where(f, old, new)
    if isinstance(new, tuple):
        leaves = [tree_freeze(n, o, frozen) for n, o in zip(new, old)]
        return type(new)(*leaves) if hasattr(new, "_fields") \
            else tuple(leaves)
    if dataclasses.is_dataclass(new):
        return dataclasses.replace(new, **{
            f.name: tree_freeze(getattr(new, f.name), getattr(old, f.name),
                                frozen)
            for f in dataclasses.fields(new) if f.init})
    raise TypeError(f"tree_freeze: unsupported leaf type {type(new).__name__}")


def tree_map(fn, *trees):
    """Apply ``fn`` to the matching tensor leaves of (named) tuples and
    dataclasses of tensors; None stays None."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, tuple):
        leaves = [tree_map(fn, *xs) for xs in zip(*trees)]
        return type(first)(*leaves) if hasattr(first, "_fields") \
            else tuple(leaves)
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(first) if f.init})
    raise TypeError(f"tree_map: unsupported leaf {type(first).__name__}")
