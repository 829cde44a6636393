"""Attribute partitioning: assign covariate columns to agents.

Twin of repro.data.partition: the paper's one attribute per agent and the
JAX package's other schemes (round_robin, blocks, overlapping, random), in
the `PARTITIONS` registry that `DataSpec.partition` names.  Partitions may
produce unequal groups; the stacked runtime needs equal ones, and the spec
layer rejects the others (`DataSpec.validate`).
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["one_per_agent", "round_robin", "contiguous_blocks",
           "overlapping_blocks", "random_partition", "validate_partition",
           "column_mask", "Partition", "PARTITIONS", "register_partition",
           "make_groups"]


def one_per_agent(n_attrs: int) -> List[List[int]]:
    """Paper default: agent i sees attribute i only."""
    return [[j] for j in range(n_attrs)]


def round_robin(n_attrs: int, n_agents: int) -> List[List[int]]:
    """Deal attributes to agents round-robin (covers D < M)."""
    if n_agents < 1:
        raise ValueError(f"need n_agents >= 1, got {n_agents}")
    if n_agents > n_attrs:
        raise ValueError(
            f"round_robin with n_agents={n_agents} > n_attrs={n_attrs} would "
            f"leave {n_agents - n_attrs} agent(s) with no attributes — every "
            f"agent needs at least one column")
    groups: List[List[int]] = [[] for _ in range(n_agents)]
    for j in range(n_attrs):
        groups[j % n_agents].append(j)
    return groups


def contiguous_blocks(n_attrs: int, n_agents: int) -> List[List[int]]:
    """Contiguous column blocks: agent i gets columns [b_i, b_{i+1}); sizes
    differ by at most one and are equal iff n_agents divides n_attrs."""
    if n_agents < 1:
        raise ValueError(f"need n_agents >= 1, got {n_agents}")
    if n_agents > n_attrs:
        raise ValueError(
            f"contiguous blocks need n_agents <= n_attrs, got "
            f"{n_agents} > {n_attrs}")
    bounds = [round(i * n_attrs / n_agents) for i in range(n_agents + 1)]
    return [list(range(bounds[i], bounds[i + 1])) for i in range(n_agents)]


def overlapping_blocks(n_attrs: int, n_agents: int,
                       overlap: int = 1) -> List[List[int]]:
    """Contiguous blocks plus `overlap` shared columns past each block end
    (cyclic), so neighbouring agents observe common attributes."""
    if overlap < 0:
        raise ValueError(f"need overlap >= 0, got {overlap}")
    base = contiguous_blocks(n_attrs, n_agents)
    if overlap > n_attrs - max(len(g) for g in base):
        raise ValueError(
            f"overlap={overlap} would wrap a group onto its own columns "
            f"(n_attrs={n_attrs}, largest block {max(len(g) for g in base)})")
    return [g + [(g[-1] + k) % n_attrs for k in range(1, overlap + 1)]
            for g in base]


def random_partition(n_attrs: int, n_agents: int,
                     seed: int = 0) -> List[List[int]]:
    """Seeded uniform-random disjoint assignment: numpy's RandomState(seed)
    permutes the columns (the JAX package's draw), dealt out as contiguous
    blocks of the permutation, sorted per agent."""
    perm = np.random.RandomState(seed).permutation(n_attrs)
    blocks = contiguous_blocks(n_attrs, n_agents)
    return [sorted(int(perm[j]) for j in g) for g in blocks]


def validate_partition(groups: Sequence[Sequence[int]], n_attrs: int) -> None:
    seen = set()
    for g in groups:
        if len(g) == 0:
            raise ValueError("empty attribute group — every agent needs >=1 attribute")
        for j in g:
            if not (0 <= j < n_attrs):
                raise ValueError(f"attribute index {j} out of range [0, {n_attrs})")
            seen.add(j)
    if seen != set(range(n_attrs)):
        missing = set(range(n_attrs)) - seen
        raise ValueError(f"attributes not covered by any agent: {sorted(missing)}")


def column_mask(groups: Sequence[Sequence[int]], n_attrs: int) -> np.ndarray:
    """(D, M) 0/1 float32 mask; row i selects agent i's columns."""
    mask = np.zeros((len(groups), n_attrs), dtype=np.float32)
    for i, g in enumerate(groups):
        for j in g:
            mask[i, j] = 1.0
    return mask


@dataclasses.dataclass(frozen=True)
class Partition:
    """Registry entry: `(n_attrs, n_agents, **options) -> groups`."""

    name: str
    fn: Callable[..., List[List[int]]]
    options: Tuple[str, ...]


PARTITIONS: Dict[str, Partition] = {}


def register_partition(name: str):
    """Register a `(n_attrs, n_agents, **options) -> groups` scheme."""

    def deco(fn):
        params = list(inspect.signature(fn).parameters)[2:]
        PARTITIONS[name] = Partition(name=name, fn=fn, options=tuple(params))
        return fn

    return deco


@register_partition("one_per_agent")
def _p_one_per_agent(n_attrs: int, n_agents: int) -> List[List[int]]:
    if n_agents != n_attrs:
        raise ValueError(
            f"one_per_agent fixes n_agents = n_attrs (= {n_attrs}), "
            f"got n_agents={n_agents}")
    return one_per_agent(n_attrs)


@register_partition("round_robin")
def _p_round_robin(n_attrs: int, n_agents: int) -> List[List[int]]:
    return round_robin(n_attrs, n_agents)


@register_partition("blocks")
def _p_blocks(n_attrs: int, n_agents: int) -> List[List[int]]:
    return contiguous_blocks(n_attrs, n_agents)


@register_partition("overlapping")
def _p_overlapping(n_attrs: int, n_agents: int,
                   overlap: int = 1) -> List[List[int]]:
    return overlapping_blocks(n_attrs, n_agents, overlap=overlap)


@register_partition("random")
def _p_random(n_attrs: int, n_agents: int, seed: int = 0) -> List[List[int]]:
    return random_partition(n_attrs, n_agents, seed=seed)


def make_groups(partition: str, n_attrs: int, n_agents: Optional[int] = None,
                options: Sequence[Tuple[str, Any]] = ()) -> List[List[int]]:
    """Resolve a registered partition into concrete groups."""
    p = PARTITIONS.get(partition)
    if p is None:
        raise ValueError(f"unknown partition {partition!r}; "
                         f"registered: {sorted(PARTITIONS)}")
    d = n_attrs if n_agents is None else n_agents
    return p.fn(n_attrs, d, **dict(options))
