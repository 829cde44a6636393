"""Topology registry: the static communication graph the agents live on.

Twin of repro.transport.topology: the `full`, `ring`, `star` and
`random_graph` graphs (numpy's seeded `default_rng` draws the same random
graph).  A builder returns a symmetric (D, D) 0/1 adjacency;
`build_topology` derives, host side and once:

    hops[i][j]   shortest-path hop count (BFS)
    ecc[i]       eccentricity: relay hops of agent i's broadcast
    bcast_tx[i]  flood transmission count: what the ledger charges per
                 broadcast (broadcast medium: a transmitting node reaches
                 all its neighbours)
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict, Tuple

import numpy as np

__all__ = ["Topology", "TopologyBuilder", "TOPOLOGIES", "register_topology",
           "build_topology", "TransportError"]


class TransportError(ValueError):
    """A transport spec names an unknown registry entry or is inconsistent."""


@dataclasses.dataclass(frozen=True)
class Topology:
    name: str
    n_agents: int
    adjacency: Tuple[Tuple[int, ...], ...]   # symmetric 0/1, zero diagonal
    hops: Tuple[Tuple[int, ...], ...]        # shortest-path hop counts
    ecc: Tuple[int, ...]                     # per-agent eccentricity
    bcast_tx: Tuple[int, ...]                # per-agent flood transmissions

    @property
    def is_complete(self) -> bool:
        return all(e == 1 for e in self.ecc)

    @property
    def max_ecc(self) -> int:
        return max(self.ecc)


@dataclasses.dataclass(frozen=True)
class TopologyBuilder:
    name: str
    fn: Callable[..., np.ndarray]
    options: Tuple[str, ...]


TOPOLOGIES: Dict[str, TopologyBuilder] = {}


def register_topology(name: str):
    """Register an `(n_agents, **options) -> (D, D) adjacency` builder."""

    def deco(fn):
        params = list(inspect.signature(fn).parameters)[1:]
        TOPOLOGIES[name] = TopologyBuilder(name=name, fn=fn,
                                           options=tuple(params))
        return fn

    return deco


def _bfs(adj: np.ndarray, root: int) -> Tuple[np.ndarray, int]:
    """Hop counts from `root` plus the flood transmission count (the root
    and every node with a BFS child transmit once; parents are the
    lowest-index neighbour of the previous layer, so the count is fixed)."""
    d = adj.shape[0]
    hops = np.full(d, -1, dtype=np.int64)
    hops[root] = 0
    frontier = [root]
    parents = np.full(d, -1, dtype=np.int64)
    while frontier:
        nxt = []
        for u in sorted(frontier):
            for v in np.flatnonzero(adj[u]):
                if hops[v] < 0:
                    hops[v] = hops[u] + 1
                    parents[v] = u
                    nxt.append(int(v))
        frontier = nxt
    transmitters = {root} | {int(p) for p in parents if p >= 0}
    return hops, len(transmitters)


def build_topology(name: str, n_agents: int, options=()) -> Topology:
    """Resolve a registered builder and derive the frozen `Topology`."""
    builder = TOPOLOGIES.get(name)
    if builder is None:
        raise TransportError(f"unknown topology {name!r}; "
                             f"registered: {sorted(TOPOLOGIES)}")
    if n_agents < 1:
        raise TransportError(f"need n_agents >= 1, got {n_agents}")
    kw = dict(options)
    unknown = sorted(set(kw) - set(builder.options))
    if unknown:
        raise TransportError(f"topology {name!r} has no option(s) {unknown}; "
                             f"valid: {sorted(builder.options)}")
    adj = np.asarray(builder.fn(n_agents, **kw), dtype=np.int64)
    if adj.shape != (n_agents, n_agents):
        raise TransportError(f"topology {name!r} returned shape {adj.shape}, "
                             f"expected ({n_agents}, {n_agents})")
    if not np.array_equal(adj, adj.T) or np.any(np.diag(adj)):
        raise TransportError(
            f"topology {name!r} must be symmetric with a zero diagonal")
    hops_rows, bcast = [], []
    for i in range(n_agents):
        hops, n_tx = _bfs(adj, i)
        if np.any(hops < 0):
            stranded = sorted(int(j) for j in np.flatnonzero(hops < 0))
            raise TransportError(
                f"topology {name!r} is disconnected (agents {stranded} "
                f"unreachable from agent {i}); every agent must be able to "
                f"relay to every other — raise p / change the seed")
        hops_rows.append(tuple(int(h) for h in hops))
        bcast.append(int(n_tx))
    ecc = tuple(max(row) if n_agents > 1 else 0 for row in hops_rows)
    return Topology(name=name, n_agents=n_agents,
                    adjacency=tuple(tuple(int(v) for v in r) for r in adj),
                    hops=tuple(hops_rows), ecc=ecc, bcast_tx=tuple(bcast))


@register_topology("full")
def full(n_agents: int) -> np.ndarray:
    """Complete graph — the paper's implicit assumption (1 hop, 1 tx)."""
    return (np.ones((n_agents, n_agents), dtype=np.int64)
            - np.eye(n_agents, dtype=np.int64))


@register_topology("ring")
def ring(n_agents: int) -> np.ndarray:
    """Cycle: each agent talks to its two neighbours."""
    adj = np.zeros((n_agents, n_agents), dtype=np.int64)
    if n_agents == 1:
        return adj
    for i in range(n_agents):
        adj[i, (i + 1) % n_agents] = 1
        adj[(i + 1) % n_agents, i] = 1
    return adj


@register_topology("star")
def star(n_agents: int) -> np.ndarray:
    """Hub-and-spoke: agent 0 is the fusion centre, leaves relay through it."""
    adj = np.zeros((n_agents, n_agents), dtype=np.int64)
    adj[0, 1:] = 1
    adj[1:, 0] = 1
    return adj


@register_topology("random_graph")
def random_graph(n_agents: int, p: float = 0.5, seed: int = 0) -> np.ndarray:
    """Erdos-Renyi G(D, p), seeded; a disconnected draw is rejected by
    `build_topology`."""
    if not 0.0 <= p <= 1.0:
        raise TransportError(f"random_graph needs 0 <= p <= 1, got {p}")
    rng = np.random.default_rng(int(seed))
    upper = rng.random((n_agents, n_agents)) < p
    adj = np.triu(upper, k=1).astype(np.int64)
    return adj + adj.T
