"""Deterministic fault traces (twin of repro.faults.trace): every event is
a pure function of (FaultSpec.seed, event tag, sweep round, agent).

The draws are the JAX package's — `fold_in` chains off `PRNGKey(spec.seed)`
with the tags below, then `uniform` / `bits` (repro_torch.prng, jax's
threefry bit for bit) — so a run here fails exactly where the JAX
package's run fails.  The uniforms are drawn in the run's float dtype, as
the JAX package draws them in jax's default one (float64 under
jax_enable_x64).

Everything a gate needs — alive, delivered, attempts, straggles, and
whether a payload is struck — is a handful of scalars per round, drawn on
the host at sweep start for all D agents at once: the sweep never reads
the card back for them.  Only a struck payload's flip mask is drawn on
the payload's device (`corrupt`).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import prng

__all__ = ["Strikes", "alive_at", "broadcast_outcome", "corrupt",
           "corrupt_hits", "corrupt_masks", "flip", "straggles"]

# event-stream tags: distinct fold_in constants keep the per-event substreams
# independent even at equal (round, agent)
_DROP = 0x0D
_STRAGGLE = 0x57
_CORRUPT = 0xC0

_NP = {torch.float32: np.float32, torch.float64: np.float64}

Agents = Union[int, Sequence[int]]


def _draw_keys(spec, tag: int, round_: int, agents: Agents) -> torch.Tensor:
    """The event keys fold_in(fold_in(fold_in(PRNGKey(seed), tag), round),
    agent) on the host: (2,) for one agent, (A, 2) for a sequence of A."""
    k = prng.fold_in(prng.fold_in(prng.PRNGKey(spec.seed), tag),
                     int(round_) & 0xFFFFFFFF)
    a = torch.as_tensor(agents, dtype=torch.int64) & 0xFFFFFFFF
    zero = torch.zeros_like(a)
    w0, w1 = prng.threefry2x32(k[0], k[1], zero, a)
    return torch.stack([w0, w1], dim=-1)


def _listed(agents: Agents) -> List[int]:
    return [int(a) for a in agents] if hasattr(agents, "__len__") else [int(agents)]


def _one_or_all(agents: Agents, values: list):
    """values (one per listed agent) as a list, or the one value for an
    int agent."""
    return values if hasattr(agents, "__len__") else values[0]


def broadcast_outcome(spec, round_: int, agents: Agents,
                      dtype: torch.dtype = torch.float32):
    """(delivered, attempts) of an agent's round-`round_` broadcast:
    `max_retries + 1` attempt draws at `drop_rate`; delivered iff one got
    through, attempts the transmissions sent (the leading failures plus
    the first success, or all of them).  (bool, int) for an int agent,
    (list, list) for a sequence: one host draw for all of them."""
    tries = int(spec.max_retries) + 1
    u = prng.uniform(_draw_keys(spec, _DROP, round_, _listed(agents)), (tries,),
                     dtype).numpy()
    ok = u >= _NP[dtype](spec.drop_rate)
    delivered = ok.any(axis=-1)
    attempts = np.where(delivered, np.argmax(ok, axis=-1) + 1, tries)
    return (_one_or_all(agents, delivered.tolist()),
            _one_or_all(agents, attempts.tolist()))


def straggles(spec, round_: int, agents: Agents,
              dtype: torch.dtype = torch.float32):
    """Whether an agent misses the round's commit window (timeout, then
    skip: no bytes spent): a bool for an int agent, a list for a
    sequence."""
    listed = _listed(agents)
    if spec.straggle_rate <= 0.0:
        return _one_or_all(agents, [False] * len(listed))
    u = prng.uniform(_draw_keys(spec, _STRAGGLE, round_, listed), (),
                     dtype).numpy()
    return _one_or_all(agents, (u < _NP[dtype](spec.straggle_rate)).tolist())


def alive_at(spec, d: int, round_: int) -> List[bool]:
    """The D agents' alive flags at sweep round `round_` from the crash
    schedule: agent a of an entry (a, down, rejoin) is dead for
    down <= r < rejoin (rejoin < 0: for good); round -1 is all alive."""
    alive = [True] * d
    for agent, down, rejoin in spec.crash:
        dead = round_ >= down and (rejoin < 0 or round_ < rejoin)
        alive[agent] = alive[agent] and not dead
    return alive


def corrupt_hits(spec, round_: int, agents: Agents,
                 dtype: torch.dtype = torch.float32) -> List[bool]:
    """Whether each agent's delivered payload this round is struck (drawn
    from the first half of the corruption key's split)."""
    agents = _listed(agents)
    if spec.corrupt_rate <= 0.0:
        return [False] * len(agents)
    kh = prng.split(_draw_keys(spec, _CORRUPT, round_, agents))[..., 0, :]
    u = prng.uniform(kh, (), dtype).numpy()
    return (u < _NP[dtype](spec.corrupt_rate)).tolist()


def corrupt_masks(spec, round_: int, agents: Agents, like: torch.Tensor
                  ) -> torch.Tensor:
    """The flip masks of the agents' payloads shaped like the row `like`
    (m,): jax.random.bits of each corruption key's second half, in the
    width of like's dtype, cut to its `corrupt_bits` low mantissa bits;
    (m,) for one agent, (A, m) for A.  The keys are hashed on the host
    (a few scalars), the masks drawn on like's device."""
    km = prng.split(_draw_keys(spec, _CORRUPT, round_, agents))[..., 1, :]
    width = 64 if like.dtype == torch.float64 else 32
    nbits = min(int(spec.corrupt_bits), 52 if width == 64 else 23)
    return prng.bits(km.to(like.device), (like.shape[-1],), width) & ((1 << nbits) - 1)


def flip(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x with `mask` XORed into its bits (through the integer view of its
    dtype; mask broadcasts over x's leading axes)."""
    itype = torch.int64 if x.dtype == torch.float64 else torch.int32
    return (x.view(itype) ^ mask.to(itype)).view(x.dtype)


class Strikes:
    """A round's corruption of a set of agents' payloads: which are struck
    (host bools, drawn at construction in the run's dtype) and their flip
    masks, drawn for every struck agent at once, in one pass on the row's
    device, at the first strike.  The engines hold one for all D agents
    (inject.RoundTrace); `corrupt` builds one for the agents it is given."""

    def __init__(self, spec, round_: int, agents: Sequence[int], dtype):
        self.spec, self.round = spec, int(round_)
        self.hit = dict(zip(agents, corrupt_hits(spec, round_, agents, dtype)))
        self._masks = None

    def __call__(self, row: torch.Tensor, agent) -> torch.Tensor:
        """The delivered row as it arrives: agent's flip mask XORed in where
        struck.  agent an int (row (m,), or (B, m) rows of that one agent)
        or a tuple of B (one row per trial, row (B, m))."""
        agents = list(agent) if isinstance(agent, tuple) else [agent]
        if not any(self.hit[a] for a in agents):
            return row
        if self._masks is None:
            struck = [a for a, h in self.hit.items() if h]
            rows = corrupt_masks(self.spec, self.round, struck, row)
            table = torch.cat([rows, torch.zeros_like(rows[:1])])
            self._masks = (table, {a: j for j, a in enumerate(struck)})
        table, slot = self._masks
        idx = [slot.get(a, len(slot)) for a in agents]  # unstruck: the zero row
        if isinstance(agent, tuple):
            return flip(row, table[torch.tensor(idx, dtype=torch.int64, device=row.device)])
        return flip(row, table[idx[0]])


def corrupt(spec, x: torch.Tensor, round_: int, agents: Agents,
            dtype: torch.dtype = None) -> torch.Tensor:
    """The payload x as delivered: where struck, every element gets up to
    `corrupt_bits` random low mantissa bits XORed in (`corrupt_masks`), so
    the payload is wrong but finite.  x is one row (m,) of agent `agents`
    (an int), a batch of rows (B, m) of that one agent, or one row per
    trial with one agent per trial (`agents` a sequence of B).  Whether a
    row is struck is drawn in the run's `dtype` (default x's); none
    struck: x itself, no device work.  The engines' own path (`Strikes`)."""
    listed = _listed(agents)
    strikes = Strikes(spec, round_, sorted(set(listed)),
                      x.dtype if dtype is None else dtype)
    return strikes(x, tuple(listed) if hasattr(agents, "__len__") else listed[0])
