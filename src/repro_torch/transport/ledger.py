"""The byte ledger: traffic accounted from what crossed the wire.

Twin of repro.transport.ledger as host-side integer bookkeeping: every
price is a Python int fixed by the spec (payload bytes of the codec times
the topology's flood transmissions), and a budget gate depends only on the
prices and the order the agents transmit in, never on the device's
numbers, so the ledger is a plain counter that never wraps (the JAX
package's int32 ledger needs `ensure_sweep_capacity`; this one does not).
A Monte-Carlo batch carries one ledger per trial (`TrialLedgers`): under a
budget the trials' orders, and so their spends, may differ.  Cost model
per ICOA sweep (m = transmitted instances):

    payload       = nbytes(m)                     one agent's row
    broadcast_i   = bcast_tx[i] * payload         flood from agent i
    gather        = sum_i broadcast_i             everyone floods once
    row-wise      = gather + sum_i broadcast_i    (incremental / fused:
                                                   one candidate per agent)
    paper-dense   = D * gather                    (re-gather per update)

Under the Sec 4.1 split (alpha > 1) each payload also carries the agent's
exact diagonal scalar.  The residual-refitting ring charges one ensemble
sum per agent update (`refit_cycle_bytes`); averaging charges nothing.  On
`full` with an exact codec each is comm_floats_per_sweep x itemsize.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

__all__ = ["Ledger", "TrialLedgers", "agent_broadcast_cost", "gather_cost",
           "icoa_sweep_cost", "refit_cycle_bytes"]


@dataclasses.dataclass(frozen=True)
class Ledger:
    """Cumulative measured wire bytes (a Python int: never wraps)."""

    spent: int = 0

    def charge(self, n_bytes: int) -> "Ledger":
        return Ledger(spent=self.spent + int(n_bytes))

    def affords(self, n_bytes: int, budget: float) -> bool:
        """True when charging `n_bytes` more stays within `budget`, floored
        to whole bytes."""
        return self.spent + int(n_bytes) <= int(budget)

    def charge_if(self, cond: bool, n_bytes: int) -> "Ledger":
        return self.charge(n_bytes) if cond else self


@dataclasses.dataclass(frozen=True)
class TrialLedgers:
    """One ledger per Monte-Carlo trial: `spent` holds B Python ints."""

    spent: Tuple[int, ...]

    @classmethod
    def empty(cls, n_trials: int) -> "TrialLedgers":
        return cls(spent=(0,) * n_trials)

    def charge(self, n_bytes) -> "TrialLedgers":
        """Charge every trial `n_bytes`, or trial b `n_bytes[b]`."""
        each = _per_trial(n_bytes, len(self.spent))
        return TrialLedgers(tuple(s + c for s, c in zip(self.spent, each)))

    def affords(self, n_bytes, budget: float) -> Tuple[bool, ...]:
        each = _per_trial(n_bytes, len(self.spent))
        return tuple(s + c <= int(budget) for s, c in zip(self.spent, each))

    def charge_if(self, cond: Sequence[bool], n_bytes) -> "TrialLedgers":
        each = _per_trial(n_bytes, len(self.spent))
        return self.charge([c if ok else 0 for ok, c in zip(cond, each)])


def _per_trial(n_bytes, n_trials: int) -> List[int]:
    """One price for every trial, or a sequence (or CPU int64 tensor) of B."""
    if not hasattr(n_bytes, "__len__"):
        return [int(n_bytes)] * n_trials
    each = [int(c) for c in n_bytes]
    if len(each) != n_trials:
        raise ValueError(f"{len(each)} prices for {n_trials} trials")
    return each


def _payload(transport, m: int, split: bool) -> int:
    return int(round(transport.codec.nbytes(m)
                     + (transport.codec.nbytes(1) if split else 0.0)))


def agent_broadcast_cost(transport, i: int, m: int, split: bool) -> int:
    """Bytes to flood agent i's row to every other agent."""
    return transport.topology.bcast_tx[i] * _payload(transport, m, split)


def gather_cost(transport, m: int, split: bool) -> int:
    """Bytes for every agent to flood its row once (the sweep-start gather)."""
    return sum(agent_broadcast_cost(transport, i, m, split)
               for i in range(transport.topology.n_agents))


def icoa_sweep_cost(transport, m: int, split: bool, row_wise: bool) -> int:
    """Full (unbudgeted) cost of one icoa sweep under the given schedule."""
    g = gather_cost(transport, m, split)
    if row_wise:
        return 2 * g
    return transport.topology.n_agents * g


def refit_cycle_bytes(transport, d: int, n: int) -> float:
    """Residual-refitting ring: one ensemble sum of n values per agent
    update (the collective's delivered payload)."""
    return d * transport.codec.nbytes(n)
