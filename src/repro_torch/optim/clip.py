"""Global-norm gradient clipping (twin of repro.optim.clip) over a tree of
tensors (dicts and lists, walked in the JAX package's leaf order: dict keys
sorted)."""
from __future__ import annotations

from typing import Any, Callable, Iterator

import torch

__all__ = ["global_norm", "clip_by_global_norm", "tree_leaves", "tree_map"]


def tree_leaves(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of `tree` and the matching leaves of `rest`, in a
    tree of the same structure, called in tree_leaves' order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32 (leaves summed one
    after another from 0, as the JAX twin's Python sum)."""
    sq = 0
    for leaf in tree_leaves(tree):
        sq = sq + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled by min(1, max_norm / (norm + 1e-12)) in fp32, each leaf
    cast back to its dtype; the norm)."""
    gn = global_norm(tree)
    scale = torch.clamp(max_norm / (gn + 1e-12), max=1.0)
    return tree_map(lambda l: (l.to(torch.float32) * scale).to(l.dtype), tree), gn
