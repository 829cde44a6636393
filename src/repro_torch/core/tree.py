"""Agent parameters as a tree: one tensor (polynomial, linear, rff) or a
dict of tensors (mlp), every leaf with the agent axis where the engines
index it (and a trial axis before it in a batch).  The engines take,
select and write agent i's parameters through these, whatever the family.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.trial_index import Agent, pick, put

__all__ = ["tree_map", "take", "store", "select", "clone"]


def tree_map(fn: Callable, *trees: Any) -> Any:
    """fn over the leaves of one or more trees of the same structure."""
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def clone(tree: Any) -> Any:
    return tree_map(torch.clone, tree)


def take(tree: Any, i: Agent, dim: int) -> Any:
    """Agent i's parameters (per trial for a (B,) index)."""
    return tree_map(lambda t: pick(t, i, dim), tree)


def store(tree: Any, i: Agent, dim: int, value: Any) -> None:
    """Agent i's parameters set to `value`, in place."""
    if isinstance(tree, dict):
        for k in tree:
            put(tree[k], i, dim, value[k])
    else:
        put(tree, i, dim, value)


def select(cond: torch.Tensor, a: Any, b: Any) -> Any:
    """torch.where(cond, a, b) leaf by leaf; cond () or one per trial
    (B,), broadcast over each leaf's trailing axes."""
    def one(x, y):
        c = cond.reshape(cond.shape + (1,) * (x.dim() - cond.dim()))
        return torch.where(c, x, y)
    return tree_map(one, a, b)
