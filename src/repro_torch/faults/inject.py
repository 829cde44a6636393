"""Sweep-side fault injection: the fault-aware twins of transport.policy
(twin of repro.faults.inject), settled on the host.

Byte semantics under faults, as in the JAX package:

  * the sweep-start gather charges only the alive agents' floods — a dead
    agent transmits nothing, and the peers keep its last delivered row;
  * each candidate broadcast charges `attempts * broadcast_cost`: a dropped
    attempt crossed the wire before it was lost, so retransmissions are
    real bytes;
  * a straggler's timeout and skip spends nothing;
  * the retry policy is bounded (FaultSpec.max_retries).

Every quantity here is a host value (prices, the trace's draws, the
policy's order), so `transport.policy.gate_schedule` settles every gate
of a sweep at its start, as it does for a budget alone.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.faults import trace
from repro_torch.transport.ledger import TrialLedgers

__all__ = ["RoundTrace", "gate_broadcast", "gate_schedule",
           "require_fault_engine"]


def require_fault_engine(transport, cfg) -> None:
    """Fault gating lives in the carried-CovState sweeps; crash schedules
    need the masked closed-form weights (the spec layer raises its own
    SpecError twin naming the fields)."""
    fl = transport.faults
    if fl is None:
        return
    if cfg.engine not in ("incremental", "fused"):
        raise ValueError(
            "fault injection gates per-row broadcasts inside the carried "
            "CovState sweep; the dense engine re-transmits everything by "
            "construction — use engine='incremental' or 'fused'")
    if fl.crash and cfg.delta > 0.0:
        raise ValueError(
            "crash schedules re-weight the ensemble over the survivors "
            "(ensemble.surviving_weights, a masked closed form); the "
            "minimax-protected weights (delta > 0) have no masked closed "
            "form — run crash faults with delta=0")


class RoundTrace:
    """One round's draws for all D agents — alive, delivered, attempts,
    straggles (host lists) and the strikes (`trace.Strikes`) — drawn once
    at sweep start, in the run's float dtype."""

    def __init__(self, spec, round_: int, d: int, dtype):
        agents = list(range(d))
        self.alive = trace.alive_at(spec, d, round_)
        self.delivered, self.attempts = trace.broadcast_outcome(
            spec, round_, agents, dtype)
        self.straggle = trace.straggles(spec, round_, agents, dtype)
        self.strike = trace.Strikes(spec, round_, agents, dtype)


def _gate_one(rt: RoundTrace, ledger_spent: int, live: bool,
              bcosts: Sequence[int], i: int, budget):
    """(ok, charge) of agent i's broadcast against one ledger's spend."""
    tx = rt.alive[i] and not rt.straggle[i]
    cost = rt.attempts[i] * bcosts[i]
    can = tx if budget is None else (tx and live
                                     and ledger_spent + cost <= int(budget))
    return can and rt.delivered[i], cost if can else 0


def gate_broadcast(rt: RoundTrace, ledger, live, bcosts: Sequence[int], i,
                   budget):
    """Fault-aware per-agent gate: ok is True iff agent i's candidate
    reached every peer this round (alive, not straggling, affordable, and
    one of the `max_retries + 1` attempts survived the drop trace); the
    ledger is charged `attempts * bcosts[i]` whenever the agent
    transmitted.  i is an int, or for TrialLedgers one agent per trial.
    Returns (ok, ledger): ok a bool, or a tuple of B."""
    if isinstance(ledger, TrialLedgers):
        agents = [int(a) for a in i] if hasattr(i, "__len__") else [i] * len(ledger.spent)
        lives = live if hasattr(live, "__len__") else [live] * len(agents)
        res = [_gate_one(rt, s, lv, bcosts, a, budget)
               for s, lv, a in zip(ledger.spent, lives, agents)]
        return (tuple(ok for ok, _ in res),
                ledger.charge([c for _, c in res]))
    ok, cost = _gate_one(rt, ledger.spent, live, bcosts, i, budget)
    return ok, ledger.charge(cost)


def gate_schedule(rt: RoundTrace, ledger, live, bcosts: Sequence[int], order,
                  budget) -> List:
    """Every fault gate of a sweep, slot by slot in `order` (a list, or
    (B, D) per trial): ([ok of slot 0, ...], the ledger after the sweep)."""
    oks = []
    slots = order.T if isinstance(order, np.ndarray) else order
    for i in slots:
        ok, ledger = gate_broadcast(rt, ledger, live, bcosts, i, budget)
        oks.append(ok)
    return oks, ledger
