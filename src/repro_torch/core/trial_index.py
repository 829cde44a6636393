"""One agent per Monte-Carlo trial: indexing a batched tensor by it.

A batched sweep updates agent i of every trial at once; under a byte budget
with the greedy_eta policy each trial orders its agents itself, so slot j
of the sweep updates agent order[b, j] in trial b, a (B,) int64 device
tensor.  These helpers take either form: a Python int is plain indexing
(the bits and launches of the shared-agent path), a (B,) tensor gathers or
scatters trial b's entry i[b].
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["Agent", "pick", "put", "add_at"]

Agent = Union[int, torch.Tensor]


def _per_trial_index(x: torch.Tensor, i: torch.Tensor, dim: int) -> torch.Tensor:
    """i (B,) as a gather/scatter index of x (B, ...) along `dim`."""
    shape = [1] * x.dim()
    shape[0] = -1
    size = list(x.shape)
    size[dim] = 1
    return i.reshape(shape).expand(size)


def pick(x: torch.Tensor, i: Agent, dim: int) -> torch.Tensor:
    """x's entry i along `dim` (>= 1): x.select(dim, i) for an int, trial
    b's entry i[b] for a (B,) index."""
    dim %= x.dim()
    if not isinstance(i, torch.Tensor):
        return x.select(dim, i)
    return x.gather(dim, _per_trial_index(x, i, dim)).squeeze(dim)


def put(x: torch.Tensor, i: Agent, dim: int, v) -> None:
    """x's entry i along `dim` set to v, in place (per trial for a (B,)
    index)."""
    dim %= x.dim()
    if not isinstance(i, torch.Tensor):
        x[(slice(None),) * dim + (i,)] = v
        return
    idx = _per_trial_index(x, i, dim)
    v = torch.as_tensor(v, dtype=x.dtype, device=x.device)
    x.scatter_(dim, idx, v.unsqueeze(dim).expand(idx.shape)
               if v.dim() == x.dim() - 1 else v.expand(idx.shape))


def add_at(x: torch.Tensor, i: Agent, dim: int, v) -> None:
    """x's entry i along `dim` increased by v, in place."""
    dim %= x.dim()
    if not isinstance(i, torch.Tensor):
        x[(slice(None),) * dim + (i,)] += v
        return
    put(x, i, dim, pick(x, i, dim) + v)
