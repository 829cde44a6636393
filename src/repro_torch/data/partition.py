"""Attribute partitioning: assign covariate columns to agents.

Twin of repro.data.partition holding the paper's scheme, one attribute per
agent; the other schemes (round_robin, blocks, overlapping, random) wait for
ROADMAP A7.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["one_per_agent", "validate_partition", "Partition", "PARTITIONS",
           "NOT_PORTED", "register_partition", "make_groups"]

# partitions of the JAX package that are not ported yet -> the ROADMAP item
NOT_PORTED = {"round_robin": "A7", "blocks": "A7", "overlapping": "A7",
              "random": "A7"}


def one_per_agent(n_attrs: int) -> List[List[int]]:
    """Paper default: agent i sees attribute i only."""
    return [[j] for j in range(n_attrs)]


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


def make_groups(partition: str, n_attrs: int, n_agents: Optional[int] = None,
                options: Sequence[Tuple[str, Any]] = ()) -> List[List[int]]:
    """Resolve a registered partition into concrete groups."""
    p = PARTITIONS.get(partition)
    if p is None:
        raise ValueError(f"unknown partition {partition!r}; "
                         f"registered: {sorted(PARTITIONS)}")
    d = n_attrs if n_agents is None else n_agents
    return p.fn(n_attrs, d, **dict(options))
