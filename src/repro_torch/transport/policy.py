"""Budget policies: which row broadcasts to spend a byte budget on.

Twin of repro.transport.policy.  Both policies gate transmissions inside
the sweep's agent loop: an agent whose broadcast would overrun
`Transport.byte_budget` is skipped (its candidate is not committed to the
shared covariance state, since nobody received the row).  They differ in
the order agents are offered the remaining budget:

    truncate     round-robin order 0..D-1, first come first served
    greedy_eta   agents ranked by the predicted objective after a nominal
                 gradient step, probed in O(D^2) off the sweep-start
                 CovState, the most promising rows first

With `byte_budget=None` both are inert: the unbudgeted round-robin sweep,
charged as one constant.  The ledger is host-side (transport.ledger), and a
gate depends only on the prices and the order, never on the device's
numbers, so `gate_schedule` settles every gate of a sweep at its start:
under greedy_eta the order is the one device value read to the host, once
a sweep.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.transport.ledger import (Ledger, TrialLedgers, gather_cost,
                                          icoa_sweep_cost)

__all__ = ["POLICIES", "budget_setup", "gate_broadcast", "gate_schedule",
           "greedy_order", "require_budget_engine"]

POLICIES = ("greedy_eta", "truncate")

AnyLedger = Union[Ledger, TrialLedgers]


def require_budget_engine(transport, engine: str) -> None:
    """A byte budget needs an engine that gates per-row broadcasts off the
    carried CovState (the spec layer raises its own SpecError twin)."""
    if transport.byte_budget is not None and engine not in ("incremental",
                                                            "fused"):
        raise ValueError(
            "byte_budget schedules gate row broadcasts off the carried "
            "CovState; the dense engine re-transmits everything by "
            "construction — use engine='incremental' or 'fused'")


def budget_setup(transport, cs0, ledger: AnyLedger, m: int, split: bool,
                 step0: torch.Tensor, alive: Sequence[bool] = None):
    """Sweep-start budget state: (live, order, bcosts, ledger).

    Unbudgeted and without faults: the whole row-wise schedule runs,
    charged as one constant; live is True and order / bcosts are None
    (round-robin, no gating).  Otherwise the gather — the floods of the
    agents that are `alive` (D bools from a fault trace; default all) —
    is charged, under a budget only if affordable (`live`, per trial for a
    batch), and `bcosts` are the D broadcast prices, for the gates to
    charge.  `order` is the greedy ranking at the engine's own back-search
    step0 (read to the host: a list of D ints, or a (B, D) int64 array for
    a batched CovState) or the round-robin identity (a list, shared by a
    batch's trials)."""
    batched = isinstance(ledger, TrialLedgers)
    budget = transport.byte_budget
    if budget is None and alive is None:
        cost = icoa_sweep_cost(transport, m, split=split, row_wise=True)
        return True, None, None, ledger.charge(cost)
    d = transport.topology.n_agents
    bcosts = transport.broadcast_costs(m, split)
    g = (gather_cost(transport, m, split) if alive is None
         else sum(c for c, a in zip(bcosts, alive) if a))
    if budget is None:
        return True, list(range(d)), bcosts, ledger.charge(g)
    live = ledger.affords(g, budget)
    ledger = ledger.charge_if(live, g)
    if transport.policy == "truncate":
        return live, list(range(d)), bcosts, ledger
    order = greedy_order(cs0, step0)[0].cpu().numpy()
    return live, order if batched else [int(i) for i in order], bcosts, ledger


def gate_broadcast(ledger: AnyLedger, live, bcosts: Sequence[int], i,
                   budget: float):
    """Per-agent budget gate: the traffic is spent whether or not the
    candidate is accepted (the broadcast precedes the decision); an
    unaffordable broadcast means nobody received the row.  i is an int, or
    for TrialLedgers one agent per trial.  Returns (can_tx, ledger)."""
    if isinstance(ledger, TrialLedgers):
        cost = ([bcosts[int(a)] for a in i] if hasattr(i, "__len__")
                else bcosts[i])
        can = tuple(lv and ok for lv, ok in zip(live, ledger.affords(cost,
                                                                     budget)))
        return can, ledger.charge_if(can, cost)
    can = bool(live) and ledger.affords(bcosts[i], budget)
    return can, ledger.charge_if(can, bcosts[i])


def gate_schedule(ledger: AnyLedger, live, bcosts: Sequence[int], order,
                  budget: float) -> Tuple[List, AnyLedger]:
    """Every gate of a sweep, slot by slot in `order`: ([can_tx of slot 0,
    ...], the ledger after the sweep).  can_tx is a bool, or a tuple of B
    for a batch (order (B, D))."""
    cans = []
    slots = order.T if isinstance(order, np.ndarray) else order
    for i in slots:
        can, ledger = gate_broadcast(ledger, live, bcosts, i, budget)
        cans.append(can)
    return cans, ledger


def greedy_order(cs, step0: torch.Tensor):
    """Agent update order by descending predicted eta after a nominal step:
    (order, scores), order[j] the j-th agent slot of the sweep, a stable
    argsort of -scores (ties keep the lower agent first).

    The cached closed-form gradient of agent i is (2/m) s_i (s^T R), so
    every agent's direction is +-(s^T R) and the probe vectors assemble
    from one shared row product; each candidate is scored with
    covstate.eta_probe's algebra at the back-search's first step, all D at
    once (per trial for a batched CovState: scores and order (B, D))."""
    d, m = cs.r_sub.shape[-2:]
    c = (cs.s[..., None, :] @ cs.r_sub)[..., 0, :]          # shared direction
    cu = c / (torch.linalg.norm(c, dim=-1, keepdim=True) + 1e-30)
    p = (cs.r_sub @ cu[..., None])[..., 0] / m              # (..., D)
    sgn = torch.sign(cs.s)
    # row i of u is agent i's probe: -(step0 sgn_i) p + e_i step0^2 / 2m
    u = -(step0 * sgn)[..., :, None] * p[..., None, :]
    diag = torch.arange(d, dtype=torch.int64, device=u.device)
    u[..., diag, diag] += step0 * step0 / (2.0 * m)
    z2 = u @ cs.m_inv.mT                                     # row i: M u_i
    k11 = torch.diagonal(cs.m_inv, dim1=-2, dim2=-1)
    k12 = 1.0 + torch.diagonal(z2, dim1=-2, dim2=-1)
    k22 = torch.sum(u * z2, dim=-1)
    det = k11 * k22 - k12 * k12
    t1, t2 = cs.s, (u @ cs.s[..., None])[..., 0]
    scores = cs.eta_tilde[..., None] - (k22 * t1 * t1 - 2.0 * k12 * t1 * t2
                                        + k11 * t2 * t2) / det
    return torch.argsort(-scores, dim=-1, stable=True), scores
