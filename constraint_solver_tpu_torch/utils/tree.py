"""Maps and selects over state trees: nested ``NamedTuple``s with tensor leaves.

The port's stand-in for ``jax.tree.map`` and the engine's ``_select``.  Every
leaf of a lane-batched state has the lane axis first, so a [P] predicate selects
whole lanes.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise to ``tree`` and the same-shaped trees in ``rest``."""
    if isinstance(tree, tuple):
        mapped = [tree_map(fn, *parts) for parts in zip(tree, *rest)]
        return type(tree)(*mapped) if hasattr(tree, "_fields") else tuple(mapped)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The tensors of a state tree, in field order."""
    if isinstance(tree, tuple):
        return [leaf for part in tree for leaf in tree_leaves(part)]
    return [tree]


def lane_where(pred: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``where(pred, a, b)`` with a [P] predicate broadcast over trailing axes."""
    return torch.where(pred.view(pred.shape + (1,) * (a.dim() - pred.dim())), a, b)


def tree_where(pred: torch.Tensor, a: Any, b: Any) -> Any:
    """Per-lane select between two state trees (the JAX engine's ``_select``)."""
    return tree_map(lambda x, y: lane_where(pred, x, y), a, b)


def tree_take(tree: Any, idx: torch.Tensor) -> Any:
    """Leaf ``[P, K, ...]`` → ``[P, ...]`` at slot ``idx[p]`` of each lane."""
    lane = torch.arange(idx.shape[0], device=idx.device)
    return tree_map(lambda x: x[lane, idx], tree)
