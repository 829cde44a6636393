"""ICOA — Iterative Covariance Optimization Algorithm (paper Sec 3.1).

One sweep (the paper's inner `for i = 1..D`):

    1. gradient of eta_tilde = 1^T A^{-1} 1 w.r.t. f_i, at the current F
    2. back-tracking search for the step size
    3. f_hat_i = f_i + step * grad
    4. project onto H_i: retrain agent i's estimator with f_hat_i as outcome
    5. accept the new row only if it improves the objective, and commit it
       before moving to agent i+1

Twin of repro.core.icoa, in PyTorch's idiom: the agent loop is a Python
loop, the back-search evaluates its whole step schedule as one batch and
takes the first improving step (the step the JAX while_loop stops at: each
probe is a pure function of its step), and accept/reject selects with
torch.where on device booleans, so the loop never waits for the device.

Minimax Protection (Sec 4.2) changes two things, via `alpha` / `delta`:
the covariance feeding the gradient is assembled from an N/alpha subsample
(fresh each sweep, drawn from the sweep's key exactly as the JAX package
draws it: core.covariance, prng), with the exact local diagonal (Sec 4.1);
and at delta > 0 the objective is the robust one (core.minimax), each agent
descending the Danskin surrogate a*^T A0(f) a* with a* held fixed.

Three engines compute the same sweep:

  * "incremental" (default): carries a core.covstate.CovState through the
    agent loop — closed-form gradient off the cached (A0+jitter)^{-1} 1 (or
    the robust weights), O(D^2) rank-2 SMW probes (robust ones at
    delta > 0), one row-Gram product per probe and one per commit
    (kernels.gram.row_gram with use_kernel).
  * "fused": the back-search collapses to a closed-form schedule off one
    matvec, accept/commit to one fused evaluation with accept selecting the
    update; with use_kernel the commit is kernels.sweep's commit kernel,
    and the probe its probe kernel at alpha = 1 or the row product on the
    subsample at alpha > 1.  At delta > 0 it delegates to the incremental
    engine, as the JAX package does.
  * "dense": the oracle — every objective evaluation rebuilds the Gram and
    re-solves from scratch, the gradient by torch.autograd.  It runs the
    plain products only: the JAX package cannot differentiate through its
    Pallas Gram, so it has no dense engine on a kernel for this one to
    match, and `use_kernel=True` is refused.

`run_scan` is the Monte-Carlo building block (api.batch_fit): B independent
trials as one batched program.  Every tensor carries a leading trial axis
(B, ...) — the explicit counterpart of the JAX package's vmap over its
run_scan — and `sweep` sends such a state to the batched twins of the
incremental and fused engines, where all trials update agent i together (i
stays a host int) and eta, the chosen step, accept/reject, the subsample
and the solve state are per trial.  With use_kernel every product goes to
the batched kernels, one launch per agent for the whole batch.  The dense
engine takes the batch as it is: it runs one trial as a batch of one.

Transport (cfg.transport, repro_torch.transport): the sweep-start gather
and every candidate row pass the codec relay before they reach the shared
state, and the ledger charges their bytes.  Under a byte budget the
incremental and fused engines offer the budget in the policy's order and a
broadcast that does not fit is not committed; every gate of a sweep is
settled on the host at its start (`_schedule`), so the agent loop still
never waits for the device, and under greedy_eta a batch's trials each
update their own agent at every slot (core.trial_index).

Keys follow the JAX package: every agent starts from `family.init` of its
key in split(PRNGKey(seed), D) (the mlp family draws its weights there);
`run` starts from PRNGKey(seed + 1), records with it, then per sweep splits
(key, k1, k2), sweeps with k1 and records with k2; `run_scan` does so per
trial.  At alpha = 1 no draw reaches the math, so the sweeps' key stream is
not computed there.

Agent parameters are a tree (core.tree): one tensor for the closed-form
families, a dict for mlp; every engine takes, selects and writes agent i's
through it.  Families other than the polynomial ones project through
`family.fit` in the fused engine too.

Taps (cfg.obs, repro_torch.obs): with an ObsSpec the sweep returns its
tap dict — each agent's acceptance after the gates, the budget's denials
and the fault trace's retries (host counts from the gates settled at
sweep start), the codec's round-trip error on the sweep-start gather —
and `run` / `run_scan` add each record's eta and solve vector s, off the
record's own Gram.  Every tap site is a Python `if` on the spec: without
taps the sweep runs exactly the device operations it ran before, and
with them it reads only values it already has.

Faults (cfg.transport.faults, repro_torch.faults): `sweep(..., round_)`
draws the round's trace on the host at sweep start; the gather charges
the alive agents only, each broadcast `attempts` times its price, and a
dead, straggling or undelivered agent's commit is gated off exactly as an
unaffordable one (can_tx, settled in `_schedule` with the budget's gates).
A delivered row may arrive bit-flipped: the strike hits the wire view
before the commit, never the sender's params and f.  Under a crash
schedule the record's weights re-solve over the survivors
(ensemble.surviving_weights).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, List, Optional, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch import transport as transport_lib
from repro_torch.analysis import sanitize
from repro_torch.agents.polynomial import PolynomialFamily, _features
from repro_torch.core import covariance as cov
from repro_torch.core import covstate, ensemble, gradient, minimax
from repro_torch.core.trial_index import add_at, pick, put
from repro_torch.core.tree import clone as tree_clone
from repro_torch.core.tree import select, store, take, tree_map
from repro_torch.faults import inject as faults_inject
from repro_torch.faults import trace as faults_trace
from repro_torch.obs import taps as obs_taps
from repro_torch.obs.spec import ObsSpec
from repro_torch.transport import Ledger, TrialLedgers, icoa_sweep_cost

__all__ = ["ICOAConfig", "ICOAState", "init_keys", "init_state", "sweep",
           "run", "run_scan", "converged_record", "ensemble_predict",
           "NotPortedError"]


class NotPortedError(NotImplementedError):
    """A configuration the JAX package supports but this port does not yet;
    the message names the ROADMAP item it waits for."""


_DENSE_KERNEL = (
    "engine='dense' runs the plain products only: the JAX package cannot "
    "differentiate through its Pallas Gram (jax.grad of the dense objective "
    "with use_kernel=True fails in pallas_call's JVP rule, ROADMAP C6), so "
    "there is no dense engine on a kernel to match; the port's dense engine "
    "is the plain-PyTorch oracle — pass use_kernel=False")


@dataclasses.dataclass(frozen=True)
class ICOAConfig:
    n_sweeps: int = 30
    eps: float = 1e-7           # outer-loop stopping tolerance on eta
    step0: float = 1.0          # initial back-search step (scaled by sqrt(N))
    backtrack: float = 0.5      # step shrink factor
    max_probes: int = 16        # back-search budget
    alpha: float = 1.0          # compression rate (1 = full residual exchange)
    delta: float = 0.0          # Minimax Protection box half-width (0 = off)
    minimax_steps: int = 300    # inner robust-weight solver budget
    minimax_lr: float = 0.05
    use_kernel: bool = False    # route the products through kernels/
    accept_reject: bool = True  # reject projections that worsen the objective
    row_broadcast: bool = False  # dense engine: gather once a sweep, then
                                # broadcast each updated row (the row-wise
                                # price); incremental/fused are row-wise
    engine: str = "incremental"  # "incremental" | "fused" | "dense"
    transport: Optional[transport_lib.Transport] = None  # None = default
    checks: str = "off"         # the sanitizer rail (analysis.sanitize):
                                # "raise" makes a failed check site an error
    obs: Optional[ObsSpec] = None  # the taps to collect (None: none)

    def validate(self) -> None:
        sanitize.validate_mode(self.checks, "ICOAConfig.checks")
        if self.engine not in ("incremental", "fused", "dense"):
            raise ValueError(f"unknown engine {self.engine!r}; pick "
                             f"'incremental', 'fused' or 'dense'")
        if self.engine == "dense" and self.use_kernel:
            raise ValueError(_DENSE_KERNEL)
        if self.max_probes < 1:
            raise ValueError("need max_probes >= 1")
        if self.alpha < 1.0 or self.delta < 0.0:
            raise ValueError(f"need alpha >= 1 and delta >= 0 (got alpha="
                             f"{self.alpha}, delta={self.delta})")


@dataclasses.dataclass
class ICOAState:
    params: Any                # stacked agent params, leading dim D
    f: torch.Tensor            # (D, N) training predictions


def init_keys(seed, d: int, device) -> torch.Tensor:
    """The agents' init keys, split(PRNGKey(seed), D): (D, 2), or
    (B, D, 2) for a sequence of B seeds, as the JAX package splits them."""
    return prng.split(prng.PRNGKey(np.asarray(seed), device=device), d)


def init_state(family, xcols: torch.Tensor, y: torch.Tensor,
               keys: Optional[torch.Tensor] = None) -> ICOAState:
    """Non-cooperative warm start: every agent fits y directly, from
    `family.init` of its key (keys (..., D, 2); None: init_keys(0, D)).
    Batched: xcols (B, D, N, C), y (B, N)."""
    d, n = xcols.shape[-3], xcols.shape[-2]
    if keys is None:
        keys = init_keys(0, d, y.device)
    p0 = family.init(keys.expand(*xcols.shape[:-3], d, 2), xcols.dtype)
    params = family.fit(p0, xcols, y[..., None, :].expand(*y.shape[:-1], d, n))
    return ICOAState(params=params, f=family.predict(params, xcols))


def _step_schedule(cfg: ICOAConfig, n: int, dtype: torch.dtype,
                   device) -> torch.Tensor:
    """steps[k] = step0 * backtrack^k in the data dtype, built on the host
    as the same left-associated multiply chain the JAX back-search performs
    (step0 = cfg.step0 * sqrt(N), the scale-free start)."""
    np_dt, t_dt = ((np.float64, torch.float64) if dtype == torch.float64
                   else (np.float32, torch.float32))
    step = np_dt(cfg.step0) * np.sqrt(np_dt(n))
    chain = [step]
    for _ in range(cfg.max_probes - 1):
        step = step * np_dt(cfg.backtrack)
        chain.append(step)
    return torch.tensor(np.asarray(chain, dtype=np_dt), dtype=t_dt, device=device)


def _first_improving(etas: torch.Tensor, eta0: torch.Tensor,
                     steps: torch.Tensor) -> torch.Tensor:
    """The first step whose probe beats eta0, or 0 if none does."""
    improved = etas > eta0
    kstar = torch.argmax(improved.to(torch.int8)).reshape(1)   # first max
    return torch.where(improved.any(), steps.gather(0, kstar)[0],
                       torch.zeros((), dtype=steps.dtype, device=steps.device))


def _first_improving_batched(etas: torch.Tensor, eta0: torch.Tensor,
                             steps: torch.Tensor) -> torch.Tensor:
    """`_first_improving` per trial: etas (B, K), eta0 (B,) -> steps (B,)."""
    improved = etas > eta0[:, None]
    kstar = torch.argmax(improved.to(torch.int8), dim=-1)       # first max
    return torch.where(improved.any(dim=-1), steps[kstar],
                       torch.zeros((), dtype=steps.dtype, device=steps.device))


def sweep(family, cfg: ICOAConfig, params: Any, f: torch.Tensor,
          xcols: torch.Tensor, y: torch.Tensor,
          key: Optional[torch.Tensor] = None,
          ledger: Optional[Union[Ledger, TrialLedgers]] = None,
          round_: int = 0):
    """One full sweep over all D agents; returns (params, f, ledger, taps),
    `taps` the sweep's tap dict of cfg.obs ({} without taps).  The inputs
    are not modified.

    At alpha > 1 the sweep splits `key` and draws its subsample of
    m = ceil(N / alpha) instances from the second half, as the JAX package
    does; at alpha = 1 the key is not read.  The ledger is charged the
    schedule's bytes: the row-wise price (the sweep-start gather plus one
    candidate-row broadcast per agent) for the incremental and fused
    engines and for the dense one with `row_broadcast`, else the paper's
    re-gather per agent update; each payload carries the agent's exact
    diagonal scalar at alpha > 1.  Under the transport's byte budget the
    incremental and fused engines charge the gather only if it is
    affordable and each candidate broadcast only while the run's total
    stays within the budget, in the policy's order (transport.policy); a
    broadcast that is not made is not committed.  Pass the ledger the
    previous sweep returned: the budget caps the run's total.  `round_`
    is the global sweep index, the fault trace's coordinate (ignored
    without faults).

    A batched state — params (B, D, P), f (B, D, N), xcols (B, D, N, C),
    y (B, N), key (B, 2) — runs all B trials through the batched engine,
    each with its own subsample, and carries one ledger per trial
    (TrialLedgers): under greedy_eta each trial orders its own agents, so
    the trials' spends may differ.

    `cfg.checks` switches the sanitizer rail for the sweep (innermost
    wins): under "raise" its check sites fold into the run's error word, or
    into the sweep's own, read as it returns (analysis.sanitize)."""
    cfg.validate()
    batched = f.dim() == 3
    with sanitize.error_scope(cfg.checks, f.shape[0] if batched else None):
        params, f, ledger, taps = _sweep(family, cfg, params, f, xcols, y,
                                         key, ledger, round_)
        f = sanitize.check_finite(f, "icoa.sweep: prediction matrix f")
    return params, f, ledger, taps


def _sweep(family, cfg: ICOAConfig, params: Any, f: torch.Tensor,
           xcols: torch.Tensor, y: torch.Tensor, key: Optional[torch.Tensor],
           ledger: Optional[Union[Ledger, TrialLedgers]], round_: int):
    d, n = f.shape[-2:]
    batched = f.dim() == 3
    tp = (cfg.transport or transport_lib.default_transport(d)).validate_for(d)
    transport_lib.require_budget_engine(tp, cfg.engine)
    faults_inject.require_fault_engine(tp, cfg)
    split = cfg.alpha > 1.0
    m = cov.subsample_size(n, cfg.alpha) if split else n
    if ledger is None:
        ledger = TrialLedgers.empty(f.shape[0]) if batched else Ledger()
    if cfg.engine == "dense":
        ledger = ledger.charge(icoa_sweep_cost(tp, m, split=split,
                                               row_wise=cfg.row_broadcast))
    idx = None
    if split:
        if key is None:
            raise ValueError(f"alpha={cfg.alpha}: the sweep draws its "
                             f"subsample from a key; pass key")
        idx = cov.subsample_indices(prng.split(key)[..., 1, :], n, cfg.alpha)
    fused = cfg.engine == "fused" and cfg.delta == 0.0
    rt = (None if tp.faults is None
          else faults_inject.RoundTrace(tp.faults, round_, d, f.dtype))
    if cfg.engine == "dense":
        params, f, taps = _sweep_dense(family, cfg, tp, tree_clone(params),
                                       f.clone(), xcols, y, idx)
        return params, f, ledger, taps
    if batched:
        engine = _sweep_fused_batched if fused else _sweep_incremental_batched
    else:
        engine = _sweep_fused if fused else _sweep_incremental
    return engine(family, cfg, tp, tree_clone(params), f.clone(), xcols, y,
                  idx, ledger, rt)


def _schedule(tp, cs0, ledger, m: int, split: bool, step0: torch.Tensor,
              rt=None):
    """The sweep's agent order and gates, settled at its start
    (transport.policy, and faults.inject under a fault trace `rt`):
    (slots, cans, agents, ledger, denied).  slots[j] is the agent of slot
    j — an int, or a (B,) int64 device tensor when each trial of a batch orders
    its own agents (greedy_eta); agents[j] is the same on the host (an
    int, or B ints).  cans[j] is None with neither a budget nor faults,
    else slot j's can_tx: a bool, or for a batch under a budget a (B,)
    bool device tensor (every gate of the sweep copied to the device at
    once; faults alone gate every trial alike: a bool).  The ledger comes
    back charged for the whole sweep.  `denied` counts the broadcasts the
    budget refused on a budgeted run without faults (an int, or B ints),
    else 0: the budget_rejects tap."""
    d = tp.topology.n_agents
    live, order, bcosts, ledger = transport_lib.budget_setup(
        tp, cs0, ledger, m, split, step0, None if rt is None else rt.alive)
    denied = 0
    if rt is not None:
        cans, ledger = faults_inject.gate_schedule(rt, ledger, live, bcosts,
                                                   order, tp.byte_budget)
    elif tp.byte_budget is None:
        return list(range(d)), [None] * d, list(range(d)), ledger, denied
    else:
        cans, ledger = transport_lib.gate_schedule(ledger, live, bcosts,
                                                   order, tp.byte_budget)
        denied = np.sum(~np.asarray(cans, dtype=bool), axis=0).tolist()
    if not isinstance(ledger, TrialLedgers):
        return order, cans, list(order), ledger, denied
    if tp.byte_budget is None:                 # the shared trace alone
        return order, [c[0] for c in cans], list(order), ledger, denied
    dev = cs0.s.device
    cans = list(torch.tensor(cans, dtype=torch.bool, device=dev).unbind(0))
    if isinstance(order, np.ndarray):          # one order per trial
        agents = [tuple(int(a) for a in col) for col in order.T]
        order = list(torch.as_tensor(np.ascontiguousarray(order.T),
                                     device=dev).unbind(0))
        return order, cans, agents, ledger, denied
    return order, cans, list(order), ledger, denied


def _retries(rt) -> int:
    """The attempts beyond the first of every agent that transmitted this
    round (alive and not straggling) under the fault trace `rt`, whatever
    the budget did: the fault_retries tap (0 without faults)."""
    if rt is None:
        return 0
    return sum(a - 1 for a, alive, late in zip(rt.attempts, rt.alive,
                                               rt.straggle)
               if alive and not late)


def _sweep_taps(cfg: ICOAConfig, f: torch.Tensor, sent, rel, denied, rt):
    """The engine taps of a sweep at its start (obs.taps), {} without
    taps: no device operation."""
    if cfg.obs is None:
        return {}
    taps = obs_taps.engine_taps(cfg.obs, f, sent, rel)
    obs_taps.tap_gates(taps, cfg.obs, denied, _retries(rt))
    return taps


def _strike(rt, row: torch.Tensor, agent) -> torch.Tensor:
    """The delivered row as it arrives under the fault trace `rt`
    (faults.inject.RoundTrace.strike): possibly bit-flipped; agent an int,
    or a tuple of B for one row per trial."""
    return row if rt is None else rt.strike(row, agent)


def _add_at(g: torch.Tensor, idx: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """g with c added at the distinct positions idx of its last axis (one
    addition per position, no atomics): idx (m,) shared, or (B, m) per
    trial for g (B, N)."""
    if idx.dim() == 1:
        g[..., idx] = g[..., idx] + c
        return g
    return g.scatter(-1, idx, torch.gather(g, -1, idx) + c)


def _split_gradient(v: torch.Tensor, r_sub: torch.Tensor, r_i: torch.Tensor,
                    idx: torch.Tensor, i, n: int) -> torch.Tensor:
    """The Sec 4.1 gradient of agent i over all N positions: the exact
    diagonal's term (2/N) v_i^2 r_i everywhere, plus the subsample's
    off-diagonal terms at the transmitted positions.  Single (v (D,), r_i
    (N,)) or per trial (v (B, D), r_i (B, N), idx (B, m), i shared or
    (B,))."""
    vi = pick(v, i, -1)
    g = ((2.0 / n) * (vi * vi))[..., None] * r_i
    return _add_at(g, idx, gradient.cached_row_gradient(v, r_sub, i,
                                                        exclude_self=True))


def _gathered_state(tp, r0: torch.Tensor, idx: Optional[torch.Tensor],
                    use_kernel: bool):
    """The sweep-start gather as the CovState it builds, the width m of its
    rows, and the rows as sent and as delivered: every row after the relay
    (its subsample at alpha > 1, with the exact local variances spliced in
    as the diagonal, Sec 4.1).  Single (r0 (D, N)) or per trial
    (r0 (B, D, N), idx (B, m))."""
    if idx is None:
        rel = tp.relay_rows(r0)
        return covstate.build(rel, use_kernel=use_kernel), r0.shape[-1], r0, rel
    exact = tp.relay_scalars(torch.sum(r0 * r0, dim=-1) / r0.shape[-1])
    sent = cov.take_cols(r0, idx)
    rel = tp.relay_rows(sent)
    return (covstate.build(rel, exact_diag=exact, use_kernel=use_kernel),
            idx.shape[-1], sent, rel)


def _delivered(tp, r_new: torch.Tensor, idx: Optional[torch.Tensor], i,
               a0_ii: torch.Tensor):
    """What agent i's candidate residual puts on the wire: the row (its
    subsample at alpha > 1) after the relay, and under the Sec 4.1 split the
    change of its exact diagonal from a0_ii (None at alpha = 1)."""
    if idx is None:
        return tp.relay_row(r_new, i), None
    sq = (torch.dot(r_new, r_new) if r_new.dim() == 1        # the JAX vdot
          else torch.sum(r_new * r_new, dim=-1))
    exact = tp.relay_scalar(sq / r_new.shape[-1], i)
    return tp.relay_row(cov.take_cols(r_new, idx), i), exact - a0_ii


def _transported_a0(tp, cfg: ICOAConfig, f: torch.Tensor, y: torch.Tensor,
                    idx: Optional[torch.Tensor]) -> torch.Tensor:
    """A0 as the agents receive it, differentiable in f (..., D, N): every
    transmitted row (and, under the Sec 4.1 split, every exact-diagonal
    scalar) passes the codec relay with straight-through gradients."""
    r = y - f
    if idx is None:
        return cov.gram(tp.relay_rows_st(r), use_kernel=cfg.use_kernel)
    exact_diag = tp.relay_scalars_st(torch.sum(r * r, dim=-1) / r.shape[-1])
    return cov.spliced_gram(tp.relay_rows_st(cov.take_cols(r, idx)),
                            exact_diag, use_kernel=cfg.use_kernel)


def _sweep_dense(family, cfg: ICOAConfig, tp, params, f, xcols, y, idx):
    """Recompute-from-scratch engine: every objective evaluation pays the
    full Gram and solve, the gradient comes from torch.autograd through
    them, and at delta > 0 the robust weights are re-solved at each
    evaluation and held fixed for the gradient (the JAX package's
    stop_gradient).  The back-search evaluates the K candidate prediction
    matrices of the schedule as one batch.

    It runs B trials at once — params (B, D, P), f (B, D, N), xcols
    (B, D, N, C), y (B, N), idx (B, m) — and one trial as a batch of one.
    Returns (params, f, taps): the taps report the codec's round trip on
    the sweep-start rows (the payload the other engines gather).
    The gradient is autograd's of the sum of the trials' objectives: each
    trial's term depends on its own row only, so every trial gets its own
    gradient; the candidates are (B, K, D, N), and the step, the robust
    weights and accept/reject are per trial."""
    if f.dim() == 2:
        p, ff, taps = _sweep_dense(family, cfg, tp,
                                   tree_map(lambda t: t[None], params),
                                   f[None], xcols[None], y[None],
                                   None if idx is None else idx[None])
        return (tree_map(lambda t: t[0], p), ff[0],
                {k: v[0] for k, v in taps.items()})
    b, d, n = f.shape
    steps = _step_schedule(cfg, n, f.dtype, f.device)
    sent = rel = None
    if cfg.obs is not None and "codec_error" in cfg.obs.taps:
        r0 = y[:, None, :] - f
        sent = r0 if idx is None else cov.take_cols(r0, idx)
        rel = tp.relay_rows(sent)
    taps = _sweep_taps(cfg, f, sent, rel, 0, None)

    def obj(ff):
        """Each trial's objective at ff (B, ..., D, N): (B, ...)."""
        yy = y.reshape(b, *([1] * (ff.dim() - 2)), n)
        a0 = _transported_a0(tp, cfg, ff, yy, idx)
        if cfg.delta > 0.0:
            a = minimax.robust_weights(a0.detach(), cfg.delta,
                                       steps=cfg.minimax_steps,
                                       lr=cfg.minimax_lr)
            return -minimax.robust_objective(a, a0, cfg.delta)
        return ensemble.eta_tilde(a0)

    for i in range(d):
        with torch.enable_grad():
            fi = f[:, i].clone().requires_grad_(True)
            val = obj(torch.cat([f[:, :i], fi[:, None], f[:, i + 1:]], dim=1))
            g = torch.autograd.grad(val.sum(), fi)[0]
        eta0 = val.detach()
        gnorm = torch.linalg.norm(g, dim=-1, keepdim=True) + 1e-30
        g_unit = g / gnorm

        cand = f[:, None].expand(b, steps.shape[0], d, n).clone()
        cand[:, :, i] = f[:, None, i] + steps[None, :, None] * g_unit[:, None]
        step = _first_improving_batched(obj(cand), eta0, steps)

        f_hat = f[:, i] + step[:, None] * g_unit
        p_old = take(params, i, 1)
        p_new = family.fit(p_old, xcols[:, i], f_hat)
        f_new = family.predict(p_new, xcols[:, i])
        if cfg.accept_reject:
            f_acc = f.clone()
            f_acc[:, i] = f_new
            accept = obj(f_acc) > eta0
        else:
            accept = torch.ones((b,), dtype=torch.bool, device=f.device)
        obs_taps.tap_accept(taps, cfg.obs, i, accept)
        store(params, i, 1, select(accept, p_new, p_old))
        f[:, i] = torch.where(accept[:, None], f_new, f[:, i])
    return params, f, taps


def _sweep_incremental(family, cfg: ICOAConfig, tp, params, f, xcols, y, idx,
                       ledger, rt=None):
    """Rank-2 CovState engine: O(N*D + D^2) per agent update.  The CovState
    is rebuilt from f at sweep start (the once-per-sweep refresh bounding SMW
    drift); every probe and commit inside is a rank-2 update.  `params` and
    `f` are this sweep's own copies and are updated row by row.

    At alpha > 1 the state holds the subsample's rows with the exact
    diagonal spliced in, the gradient is the split one (`_split_gradient`)
    and every update moves the diagonal by its exact change.  At delta > 0
    the objective is the robust one: the weights a* are solved warm from the
    cached s / sum(s), the gradient is the Danskin term at a*, and every
    probe re-solves a* on its perturbed A0 (covstate.robust_eta_probe, the
    whole schedule in one call).  Under a byte budget the agents go in the
    policy's order and a candidate whose broadcast is not made is
    rejected (`_schedule`); under faults, likewise one that does not
    arrive, and the delivered row may be struck (`_strike`)."""
    d, n = f.shape
    uk = cfg.use_kernel
    protected = cfg.delta > 0.0
    cs, m, sent, rel = _gathered_state(tp, y[None, :] - f, idx, uk)
    steps = _step_schedule(cfg, n, f.dtype, f.device)
    r_sub = cs.r_sub        # the sweep's own buffer: committed rows land in place
    order, cans, agents, ledger, denied = _schedule(tp, cs, ledger, m,
                                                    idx is not None, steps[0], rt)
    taps = _sweep_taps(cfg, f, sent, rel, denied, rt)

    def probe(state, u):
        if protected:
            return covstate.robust_eta_probe(state, i, u, cfg.delta,
                                             cfg.minimax_steps, cfg.minimax_lr)
        return covstate.eta_probe(state, i, u)

    for i, can_tx, agent in zip(order, cans, agents):
        if protected:
            v = minimax.robust_weights(cs.a0, cfg.delta, steps=cfg.minimax_steps,
                                       lr=cfg.minimax_lr,
                                       a_init=cs.s / torch.sum(cs.s))
            eta0 = -minimax.robust_objective(v, cs.a0, cfg.delta)
        else:
            v, eta0 = cs.s, cs.eta_tilde
        r_i = y - f[i]
        if idx is None:
            g = gradient.cached_row_gradient(v, r_sub, i)
        else:
            g = _split_gradient(v, r_sub, r_i, idx, i, n)
        gnorm = torch.linalg.norm(g) + 1e-30
        g_unit = g / gnorm

        # back-search: one row-Gram product, then the O(D^2) SMW probe of
        # every step of the schedule at once — the residual delta of probing
        # `step` is -step * g_unit
        g_sub = g_unit if idx is None else cov.take_cols(g_unit, idx)
        p = covstate.row_product(g_sub, r_sub, use_kernel=uk) / m
        u = -steps[:, None] * p[None, :]
        if idx is None:
            gg = torch.dot(g_sub, g_sub)
            u[:, i] += steps * steps * gg / (2.0 * m)
        else:
            c1 = torch.dot(r_i, g_unit)           # exact-diagonal cross term
            u[:, i] = 0.5 * ((steps * steps - 2.0 * steps * c1) / n)
        step = _first_improving(probe(cs, u), eta0, steps)

        f_hat = f[i] + step * g_unit
        p_old = take(params, i, 0)
        p_new = family.fit(p_old, xcols[i], f_hat)
        f_new = family.predict(p_new, xcols[i])

        # accept/reject and commit share one rank-2 row update; the candidate
        # row passes the codec relay (and the fault trace's strike) before
        # it touches the shared state
        r_new_sub, ddiag = _delivered(tp, y - f_new, idx, i, cs.a0[i, i])
        r_new_sub = _strike(rt, r_new_sub, agent)
        u_acc = covstate.row_update_vector(cs, i, r_new_sub - r_sub[i],
                                           ddiag=ddiag, use_kernel=uk)
        if cfg.accept_reject:
            accept = probe(cs, u_acc) > eta0
        else:
            accept = torch.ones((), dtype=torch.bool, device=f.device)
        if can_tx is False:                     # the broadcast was not made
            accept = torch.zeros_like(accept)
        obs_taps.tap_accept(taps, cfg.obs, i, accept)

        store(params, i, 0, select(accept, p_new, p_old))
        f[i] = torch.where(accept, f_new, f[i])
        m_inv, s, eta_t = covstate.apply_inverse_update(cs, i, u_acc)
        a0 = cs.a0.clone()
        a0[i, :] += u_acc
        a0[:, i] += u_acc
        r_sub[i] = torch.where(accept, r_new_sub, r_sub[i])
        cs = covstate.CovState(
            r_sub=r_sub, a0=torch.where(accept, a0, cs.a0),
            m_inv=torch.where(accept, m_inv, cs.m_inv),
            s=torch.where(accept, s, cs.s),
            eta_tilde=torch.where(accept, eta_t, cs.eta_tilde))
    return params, f, ledger, taps


def _sweep_incremental_batched(family, cfg: ICOAConfig, tp, params, f,
                               xcols, y, idx, ledger, rt=None):
    """`_sweep_incremental` for B trials at once: one batched CovState, every
    trial updating agent i together (or, under greedy_eta with a budget,
    each its own agent i[b], a (B,) device index), each with its own
    subsample idx (B, m); the step, accept/reject, the budget gate and the
    commit are per trial (torch.where on (B,) booleans, no host wait)."""
    d, n = f.shape[-2:]
    uk = cfg.use_kernel
    protected = cfg.delta > 0.0
    cs, m, sent, rel = _gathered_state(tp, y[:, None, :] - f, idx, uk)
    steps = _step_schedule(cfg, n, f.dtype, f.device)
    r_sub = cs.r_sub
    order, cans, agents, ledger, denied = _schedule(tp, cs, ledger, m,
                                                    idx is not None, steps[0], rt)
    taps = _sweep_taps(cfg, f, sent, rel, denied, rt)

    def probe(state, u):
        if protected:
            return covstate.robust_eta_probe(state, i, u, cfg.delta,
                                             cfg.minimax_steps, cfg.minimax_lr)
        return covstate.eta_probe(state, i, u)

    for i, can_tx, agent in zip(order, cans, agents):
        if protected:
            v = minimax.robust_weights(cs.a0, cfg.delta, steps=cfg.minimax_steps,
                                       lr=cfg.minimax_lr,
                                       a_init=cs.s / torch.sum(cs.s, dim=-1,
                                                               keepdim=True))
            eta0 = -minimax.robust_objective(v, cs.a0, cfg.delta)   # (B,)
        else:
            v, eta0 = cs.s, cs.eta_tilde
        r_i = y - pick(f, i, 1)                                   # (B, N)
        if idx is None:
            g = gradient.cached_row_gradient(v, r_sub, i)         # (B, m)
        else:
            g = _split_gradient(v, r_sub, r_i, idx, i, n)         # (B, N)
        gnorm = torch.linalg.norm(g, dim=-1) + 1e-30
        g_unit = g / gnorm[:, None]

        g_sub = g_unit if idx is None else cov.take_cols(g_unit, idx)
        p = covstate.row_product(g_sub, r_sub, use_kernel=uk) / m  # (B, D)
        u = -steps[None, :, None] * p[:, None, :]                 # (B, K, D)
        if idx is None:
            gg = torch.sum(g_sub * g_sub, dim=-1)
            add_at(u, i, 2, steps[None, :] * steps[None, :] * gg[:, None]
                   / (2.0 * m))
        else:
            c1 = torch.sum(r_i * g_unit, dim=-1)
            st = steps[None, :]
            put(u, i, 2, 0.5 * ((st * st - 2.0 * st * c1[:, None]) / n))
        step = _first_improving_batched(probe(cs, u), eta0, steps)

        f_hat = pick(f, i, 1) + step[:, None] * g_unit
        p_old = take(params, i, 1)
        p_new = family.fit(p_old, pick(xcols, i, 1), f_hat)
        f_new = family.predict(p_new, pick(xcols, i, 1))

        r_new_sub, ddiag = _delivered(tp, y - f_new, idx, i,
                                      pick(pick(cs.a0, i, 1), i, 1))
        r_new_sub = _strike(rt, r_new_sub, agent)
        u_acc = covstate.row_update_vector(cs, i, r_new_sub - pick(r_sub, i, 1),
                                           ddiag=ddiag, use_kernel=uk)
        if cfg.accept_reject:
            accept = probe(cs, u_acc) > eta0
        else:
            accept = torch.ones(eta0.shape, dtype=torch.bool, device=f.device)
        if can_tx is not None:
            accept = accept & can_tx
        obs_taps.tap_accept(taps, cfg.obs, i, accept)

        store(params, i, 1, select(accept, p_new, p_old))
        put(f, i, 1, torch.where(accept[:, None], f_new, pick(f, i, 1)))
        m_inv, s, eta_t = covstate.apply_inverse_update(cs, i, u_acc)
        a0 = cs.a0.clone()
        add_at(a0, i, 1, u_acc)
        add_at(a0, i, 2, u_acc)
        put(r_sub, i, 1, torch.where(accept[:, None], r_new_sub,
                                     pick(r_sub, i, 1)))
        cs = covstate.CovState(
            r_sub=r_sub, a0=torch.where(accept[:, None, None], a0, cs.a0),
            m_inv=torch.where(accept[:, None, None], m_inv, cs.m_inv),
            s=torch.where(accept[:, None], s, cs.s),
            eta_tilde=torch.where(accept, eta_t, cs.eta_tilde))
    return params, f, ledger, taps


def _small_inv(gm: torch.Tensor) -> torch.Tensor:
    """Batched inverse for trailing (P, P), P static and tiny: the cofactor
    form for P <= 2, torch.linalg.inv otherwise."""
    p = gm.shape[-1]
    if p == 1:
        return 1.0 / gm
    if p == 2:
        a, b = gm[..., 0, 0], gm[..., 0, 1]
        c, d = gm[..., 1, 0], gm[..., 1, 1]
        det = a * d - b * c
        return torch.stack([torch.stack([d, -b], -1),
                            torch.stack([-c, a], -1)], -2) / det[..., None, None]
    return torch.linalg.inv(gm)


def _poly_projector(xcols: torch.Tensor, degree: int, ridge: float):
    """Per-agent ridge projector for PolynomialFamily, precomputed once per
    sweep: phiT (..., D, P, N) transposed features and Ginv (..., D, P, P) =
    (phi^T phi + ridge I)^{-1}, the P x P Gram summed entry by entry over
    contiguous phiT rows as the JAX package does."""
    phi_t = _features(xcols, degree).transpose(-1, -2).contiguous()
    p = phi_t.shape[-2]
    rows = []
    for a in range(p):
        rows.append(torch.stack([torch.sum(phi_t[..., a, :] * phi_t[..., b, :],
                                           dim=-1)
                                 for b in range(p)], -1))
    eye = torch.eye(p, dtype=phi_t.dtype, device=phi_t.device)
    return phi_t, _small_inv(torch.stack(rows, -2) + ridge * eye)


def _sweep_fused(family, cfg: ICOAConfig, tp, params, f, xcols, y, idx,
                 ledger, rt=None):
    """Fused engine: the incremental sweep with its back-search in closed
    form (kernels.sweep.ref.probe_etas_closed) and accept/commit as one
    evaluation with accept selecting the rank-2 update.

    At alpha = 1, with use_kernel the probe pass (cross, p, ||g||, schedule)
    and the commit pass are kernels.sweep's kernels; without it the probe
    product needs no pass over R at all: R @ g_unit = (2 s_i / (m gnorm)) *
    (A0 @ s) on the carried Gram.  At alpha > 1 the spliced diagonal breaks
    that identity, so the probe keeps its row product on the subsample
    (kernels.gram.row_gram with use_kernel), and the commit takes
    diag_keep = 0 and diag_add = half the exact diagonal's change, a device
    value.  Under a byte budget or faults the agents go in the policy's
    order and the commit takes the broadcast's gate as can_tx, a Python
    bool (by value in the kernel); a struck row reaches the commit as
    delivered.  Both branches mirror the JAX engine exactly (the kernel
    branch runs its algebra in fp32 whatever the data dtype)."""
    from repro_torch.kernels.sweep import ops as sweep_ops
    from repro_torch.kernels.sweep import ref as sweep_ref

    d, n = f.shape
    uk = cfg.use_kernel
    dt, dev = f.dtype, f.device
    cs0, m, sent, rel = _gathered_state(tp, y[None, :] - f, idx, uk)
    rs, a0, m_inv, s, eta = cs0.r_sub, cs0.a0, cs0.m_inv, cs0.s, cs0.eta_tilde
    steps = _step_schedule(cfg, n, dt, dev)
    order, cans, agents, ledger, denied = _schedule(tp, cs0, ledger, m,
                                                    idx is not None, steps[0], rt)
    taps = _sweep_taps(cfg, f, sent, rel, denied, rt)
    zero = torch.zeros((), dtype=dt, device=dev)
    half_n = 0.5 / torch.full((), n, dtype=dt, device=dev)
    commit = sweep_ops.commit_sweep if uk else sweep_ref.commit_sweep_ref

    if isinstance(family, PolynomialFamily):
        phi_t, ginv = _poly_projector(xcols, family.degree, family.ridge)

        def project(i, p_old, f_hat):
            p_new = ginv[i] @ (phi_t[i] @ f_hat)
            return p_new, p_new @ phi_t[i]
    else:
        def project(i, p_old, f_hat):
            p_new = family.fit(p_old, xcols[i], f_hat)
            return p_new, family.predict(p_new, xcols[i])

    threshold_off = float("-inf")
    for i, can_tx, agent in zip(order, cans, agents):
        eta0 = eta
        # --- probe: gradient + the whole back-search schedule ---
        if idx is not None:
            r_i = y - f[i]
            g = _split_gradient(s, rs, r_i, idx, i, n)
            gnorm = torch.linalg.norm(g) + 1e-30
            g_unit = g / gnorm
            p = covstate.row_product(cov.take_cols(g_unit, idx), rs,
                                     use_kernel=uk) / m
            p[i].zero_()          # a device fill: no host copy
            c1 = torch.dot(r_i, g_unit)           # exact-diagonal cross term
            etas = sweep_ref.probe_etas_closed(m_inv, s, eta, i, steps, p,
                                               -c1 / n, half_n)
        elif uk:
            etas, cross, _, gnorm = sweep_ops.probe_sweep(rs, m_inv, s, eta, i,
                                                          steps)
            g_unit = ((2.0 / m) * s[i] / gnorm) * cross
        else:
            g = gradient.cached_row_gradient(s, rs, i)
            gnorm = torch.linalg.norm(g) + 1e-30
            g_unit = g / gnorm
            p = (2.0 * s[i] / (m * gnorm)) * (a0 @ s)
            gg = torch.dot(g_unit, g_unit)
            etas = sweep_ref.probe_etas_closed(m_inv, s, eta, i, steps, p,
                                               zero, gg / (2.0 * m))
        step = _first_improving(etas, eta0, steps)

        # --- projection onto H_i ---
        f_hat = f[i] + step * g_unit
        p_old = take(params, i, 0)
        p_new, f_new = project(i, p_old, f_hat)

        # --- fused accept/commit ---
        r_new_sub, ddiag = _delivered(tp, y - f_new, idx, i, a0[i, i])
        r_new_sub = _strike(rt, r_new_sub, agent)
        diag_keep, diag_add = (1.0, 0.0) if ddiag is None else (0.0, 0.5 * ddiag)
        threshold = eta0 if cfg.accept_reject else threshold_off
        m_inv, s, u_eff, accept, _ = commit(rs, m_inv, s, eta, i,
                                            r_new_sub - rs[i], diag_keep,
                                            diag_add, threshold,
                                            True if can_tx is None else can_tx)
        eta = torch.sum(s)
        obs_taps.tap_accept(taps, cfg.obs, i, accept)

        store(params, i, 0, select(accept, p_new, p_old))
        f[i] = torch.where(accept, f_new, f[i])
        a0[i, :] += u_eff                      # u_eff = 0 on reject
        a0[:, i] += u_eff
        rs[i] = torch.where(accept, r_new_sub, rs[i])
    return params, f, ledger, taps


def _sweep_fused_batched(family, cfg: ICOAConfig, tp, params, f, xcols, y,
                         idx, ledger, rt=None):
    """`_sweep_fused` for B trials at once: one batched probe (or row
    product) launch and one batched commit launch per agent with
    use_kernel; eta, threshold, the accept flags, the subsample, the
    commit's diag_add and the budget gate (can_tx) per trial as (B,) device
    tensors.  Under greedy_eta with a budget each trial updates its own
    agent at each slot: the kernels take the (B,) agent index."""
    from repro_torch.kernels.sweep import ops as sweep_ops
    from repro_torch.kernels.sweep import ref as sweep_ref

    d, n = f.shape[-2:]
    uk = cfg.use_kernel
    dt, dev = f.dtype, f.device
    cs0, m, sent, rel = _gathered_state(tp, y[:, None, :] - f, idx, uk)
    rs, a0, m_inv, s, eta = cs0.r_sub, cs0.a0, cs0.m_inv, cs0.s, cs0.eta_tilde
    steps = _step_schedule(cfg, n, dt, dev)
    order, cans, agents, ledger, denied = _schedule(tp, cs0, ledger, m,
                                                    idx is not None, steps[0], rt)
    taps = _sweep_taps(cfg, f, sent, rel, denied, rt)
    zero = torch.zeros((), dtype=dt, device=dev)
    half_n = 0.5 / torch.full((), n, dtype=dt, device=dev)
    commit = sweep_ops.commit_sweep if uk else sweep_ref.commit_sweep_batched_ref

    if isinstance(family, PolynomialFamily):
        phi_t, ginv = _poly_projector(xcols, family.degree, family.ridge)

        def project(i, p_old, f_hat):
            gi, pi = pick(ginv, i, 1), pick(phi_t, i, 1)
            p_new = (gi @ (pi @ f_hat[..., None]))[..., 0]
            return p_new, (p_new[:, None, :] @ pi)[:, 0]
    else:
        def project(i, p_old, f_hat):
            p_new = family.fit(p_old, pick(xcols, i, 1), f_hat)
            return p_new, family.predict(p_new, pick(xcols, i, 1))

    threshold_off = float("-inf")
    for i, can_tx, agent in zip(order, cans, agents):
        eta0 = eta                                                # (B,)
        if idx is not None:
            r_i = y - pick(f, i, 1)
            g = _split_gradient(s, rs, r_i, idx, i, n)
            gnorm = torch.linalg.norm(g, dim=-1) + 1e-30
            g_unit = g / gnorm[:, None]
            p = covstate.row_product(cov.take_cols(g_unit, idx), rs,
                                     use_kernel=uk) / m
            put(p, i, 1, 0.0)
            c1 = torch.sum(r_i * g_unit, dim=-1)
            etas = sweep_ref.probe_etas_closed_batched(
                m_inv, s, eta, i, steps, p, -c1 / n, half_n)
        elif uk:
            etas, cross, _, gnorm = sweep_ops.probe_sweep(rs, m_inv, s, eta, i,
                                                          steps)
            g_unit = ((2.0 / m) * pick(s, i, 1) / gnorm)[:, None] * cross
        else:
            g = gradient.cached_row_gradient(s, rs, i)
            gnorm = torch.linalg.norm(g, dim=-1) + 1e-30
            g_unit = g / gnorm[:, None]
            p = ((2.0 * pick(s, i, 1) / (m * gnorm))[:, None]
                 * (a0 @ s[..., None])[..., 0])
            gg = torch.sum(g_unit * g_unit, dim=-1)
            etas = sweep_ref.probe_etas_closed_batched(
                m_inv, s, eta, i, steps, p, zero, gg / (2.0 * m))
        step = _first_improving_batched(etas, eta0, steps)

        f_hat = pick(f, i, 1) + step[:, None] * g_unit
        p_old = take(params, i, 1)
        p_new, f_new = project(i, p_old, f_hat)

        r_new_sub, ddiag = _delivered(tp, y - f_new, idx, i,
                                      pick(pick(a0, i, 1), i, 1))
        r_new_sub = _strike(rt, r_new_sub, agent)
        diag_keep, diag_add = (1.0, 0.0) if ddiag is None else (0.0, 0.5 * ddiag)
        threshold = eta0 if cfg.accept_reject else threshold_off
        m_inv, s, u_eff, accept, _ = commit(rs, m_inv, s, eta, i,
                                            r_new_sub - pick(rs, i, 1),
                                            diag_keep, diag_add, threshold,
                                            True if can_tx is None else can_tx)
        eta = torch.sum(s, dim=-1)
        obs_taps.tap_accept(taps, cfg.obs, i, accept)

        store(params, i, 1, select(accept, p_new, p_old))
        put(f, i, 1, torch.where(accept[:, None], f_new, pick(f, i, 1)))
        add_at(a0, i, 1, u_eff)                # u_eff = 0 on reject
        add_at(a0, i, 2, u_eff)
        put(rs, i, 1, torch.where(accept[:, None], r_new_sub, pick(rs, i, 1)))
    return params, f, ledger, taps


def _weights(f: torch.Tensor, y: torch.Tensor, cfg: ICOAConfig,
             key: Optional[torch.Tensor] = None,
             alive: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ensemble weights from what the agents can see (per trial for a
    batched f (B, D, N), y (B, N), key (B, 2)): at alpha > 1 the covariance
    of a subsample drawn from `key` with the exact diagonal, the robust
    weights at delta > 0, else the closed form — over the survivors
    `alive` (D,) under a crash schedule (never with delta > 0)."""
    r = y[..., None, :] - f
    if cfg.alpha > 1.0:
        a0 = cov.subsampled_covariance(key, r, cfg.alpha,
                                       use_kernel=cfg.use_kernel)
    else:
        a0 = cov.gram(r, use_kernel=cfg.use_kernel)
    if cfg.delta > 0.0:
        return minimax.robust_weights(a0, cfg.delta, steps=cfg.minimax_steps,
                                      lr=cfg.minimax_lr)
    if alive is not None:
        return ensemble.surviving_weights(a0, alive)
    return ensemble.optimal_weights(a0)


def _alive(cfg: ICOAConfig, d: int, round_: int, device) -> Optional[torch.Tensor]:
    """The record's survivors after sweep `round_` under a crash schedule
    (a host list copied to the device), else None."""
    fl = cfg.transport.faults if cfg.transport is not None else None
    if fl is None or not fl.crash:
        return None
    return torch.tensor(faults_trace.alive_at(fl, d, round_), dtype=torch.bool,
                        device=device)


def ensemble_predict(family, params: Any, weights: torch.Tensor,
                     xcols: torch.Tensor) -> torch.Tensor:
    return ensemble.combine(weights, family.predict(params, xcols))


def converged_record(eta: Union[List[float], torch.Tensor], eps: float):
    """Record index where `run`'s eps rule stops, from a full eta history:
    the first record k >= 2 with |eta[k] - eta[k-1]| < eps, else the last
    (record 0 is the non-cooperative init, record 1 has no predecessor).

    A tensor of histories (..., R) — run_scan's per-trial etas — gives an
    int64 tensor (...,) of records, computed in eta's dtype as the JAX
    package's closed form is."""
    if isinstance(eta, torch.Tensor):
        last = eta.shape[-1] - 1
        full = torch.full(eta.shape[:-1], last, dtype=torch.int64,
                          device=eta.device)
        if eta.shape[-1] < 3:
            return full
        hit = torch.abs(eta[..., 2:] - eta[..., 1:-1]) < eps
        first = torch.argmax(hit.to(torch.int8), dim=-1) + 2
        return torch.where(hit.any(dim=-1), first, full)
    last = len(eta) - 1
    for k in range(2, len(eta)):
        if abs(eta[k] - eta[k - 1]) < eps:
            return k
    return last


def _record_eta(cfg: ICOAConfig, r: torch.Tensor, checked: bool = False):
    """A record's eta = 1 / eta_tilde of the full residual Gram of r
    (..., D, N), and its record taps (obs.taps.record_taps): the eta tap is
    this very value and the s tap the solve vector eta_tilde sums, so with
    taps the record computes what it computes without them.  `checked`:
    run_scan's check site on the divisor (the JAX package checks there)."""
    a0 = cov.subsampled_gram(r, None, use_kernel=cfg.use_kernel)
    s = ensemble.solve_vec(a0)
    eta_tilde = torch.sum(s, dim=-1)         # ensemble.eta_tilde's own ops
    if checked:
        eta_tilde = sanitize.check_nonzero(
            eta_tilde, "icoa.run_scan record: eta_tilde (eta = 1/eta_tilde)")
    eta = 1.0 / eta_tilde
    return eta, obs_taps.record_taps(cfg.obs, eta, s)


def _full_fp32(fn):
    """Run fn with plain float32 matrix products in full fp32 on the card
    (TF32 off, PyTorch's default), and give the caller back the TF32 flag
    as it found it, whatever fn does."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
    return call


def _first_key(cfg: ICOAConfig, seed, device) -> Optional[torch.Tensor]:
    """PRNGKey(seed + 1) — one key per trial for a sequence of seeds — the
    record-0 key of a run; None at alpha = 1, where no draw reaches the
    math."""
    if cfg.alpha == 1.0:
        return None
    return prng.PRNGKey(np.asarray(seed) + 1, device=device)


def _split3(key: Optional[torch.Tensor]):
    """A sweep's `key, k1, k2 = split(key, 3)`: the next key, the sweep's
    and the record's (all None at alpha = 1)."""
    if key is None:
        return None, None, None
    return prng.split(key, 3).unbind(-2)


@_full_fp32
def run(family, cfg: ICOAConfig, xcols: torch.Tensor, y: torch.Tensor,
        xcols_test: Optional[torch.Tensor] = None,
        y_test: Optional[torch.Tensor] = None, seed: int = 0):
    """Full ICOA run; returns (state, weights, history dict).

    The history holds one record per sweep plus record 0 (the
    non-cooperative init): train_mse, test_mse, eta (= 1/eta_tilde of the
    record-time full-data residual covariance) and the bytes the sweep put
    on the wire (record 0: 0).  The weights of each record come from what
    the agents can see (`_weights`: the subsample drawn from the record's
    key at alpha > 1, robust at delta > 0, over the survivors of the
    sweep's round under a crash schedule).  The run stops after a sweep
    whose eta moved less than cfg.eps from the previous sweep's.  `seed`
    seeds the init keys (split(PRNGKey(seed), D)) and the key stream
    (PRNGKey(seed + 1)), as in the JAX package; sweep r is fault round r.
    With cfg.obs, hist["taps"] holds each tap stacked over the sweeps
    (sweep k is record k + 1; obs.taps), else {}.
    Plain float32 matrix products on the card stay full fp32: TF32 is off
    for the call (PyTorch's default) and the caller's setting is restored
    after it.  With cfg.checks="raise" the sweeps' check sites fold into
    the run's error word, read after each record (which waits on the
    device anyway): the first failure raises analysis.CheckError."""
    cfg.validate()
    with sanitize.error_scope(cfg.checks) as word:
        return _run(family, cfg, xcols, y, xcols_test, y_test, seed, word)


def _run(family, cfg: ICOAConfig, xcols: torch.Tensor, y: torch.Tensor,
         xcols_test: Optional[torch.Tensor], y_test: Optional[torch.Tensor],
         seed: int, word: Optional[sanitize.ErrorWord]):
    d = xcols.shape[-3]
    state = init_state(family, xcols, y, init_keys(seed, d, y.device))
    hist = {"train_mse": [], "test_mse": [], "eta": [], "bytes": [0.0]}
    key = _first_key(cfg, seed, y.device)
    tap_rows = []

    def record(params, f, key, alive=None):
        w = _weights(f, y, cfg, key, alive)
        hist["train_mse"].append(float(torch.mean((y - ensemble.combine(w, f)) ** 2)))
        if xcols_test is not None:
            pred = ensemble_predict(family, params, w, xcols_test)
            hist["test_mse"].append(float(torch.mean((y_test - pred) ** 2)))
        eta, rtaps = _record_eta(cfg, y[None, :] - f)
        hist["eta"].append(float(eta))
        return w, rtaps

    weights, _ = record(state.params, state.f, key)
    eta_prev = math.inf
    ledger = Ledger()
    for r in range(cfg.n_sweeps):
        key, k1, k2 = _split3(key)
        params, f, led2, etaps = sweep(family, cfg, state.params, state.f,
                                       xcols, y, k1, ledger, r)
        hist["bytes"].append(float(led2.spent - ledger.spent))
        ledger = led2
        state = ICOAState(params=params, f=f)
        weights, rtaps = record(params, f, k2, _alive(cfg, d, r, y.device))
        if word is not None:
            word.throw()
        if cfg.obs is not None:
            tap_rows.append({**etaps, **rtaps})
        eta_now = hist["eta"][-1]
        if abs(eta_prev - eta_now) < cfg.eps:
            break
        eta_prev = eta_now
    hist["taps"] = obs_taps.stack_tap_rows(tap_rows)
    return state, weights, hist


@_full_fp32
def run_scan(family, cfg: ICOAConfig, xcols: torch.Tensor, y: torch.Tensor,
             xcols_test: torch.Tensor, y_test: torch.Tensor,
             seeds: Optional[List[int]] = None):
    """B independent ICOA runs as one batched program — the Monte-Carlo
    building block (api.batch_fit), twin of the JAX package's
    `jax.vmap(run_scan)`.

    xcols (B, D, N, C), y (B, N), xcols_test (B, D, N_test, C), y_test
    (B, N_test); trial b's key stream starts from PRNGKey(seeds[b] + 1)
    (seeds default to 0 .. B-1).  Same math as `run`, but the schedule is
    static: exactly cfg.n_sweeps sweeps run and eps stops nothing.  Returns
    (params (B, D, P), f (B, D, N), weights (B, D), hist) with
    hist["train_mse"], ["test_mse"] and ["eta"] (B, n_sweeps + 1) tensors
    in the data dtype (record 0 is the non-cooperative init; params a
    tree of (B, D, ...) leaves for the mlp family),
    hist["converged_at"] (B,) — the record where `run`'s eps rule would
    have stopped — hist["trial_bytes"], each trial's host ledger's bytes
    per record (record 0: 0), and hist["bytes"], their one list when every
    trial's agree (always without a byte budget), else None; with cfg.obs,
    hist["taps"], each tap (B, n_sweeps, ...), else {}.  Nothing in the
    loop waits for the device.  TF32 is off for the call, as in `run`.
    With cfg.checks="raise" the check sites fold into one error word per
    trial, read once at the end: a failure raises analysis.CheckError
    naming the site and the first failing trial."""
    cfg.validate()
    if xcols.dim() != 4 or y.dim() != 2:
        raise ValueError(f"run_scan: expected xcols (B, D, N, C) and y (B, N), "
                         f"got {tuple(xcols.shape)} and {tuple(y.shape)}")
    if seeds is None:
        seeds = list(range(y.shape[0]))
    if len(seeds) != y.shape[0]:
        raise ValueError(f"run_scan: {len(seeds)} seeds for {y.shape[0]} trials")
    with sanitize.error_scope(cfg.checks, y.shape[0]):
        return _run_scan(family, cfg, xcols, y, xcols_test, y_test, seeds)


def _run_scan(family, cfg: ICOAConfig, xcols: torch.Tensor, y: torch.Tensor,
              xcols_test: torch.Tensor, y_test: torch.Tensor, seeds: List[int]):
    d = xcols.shape[-3]
    state = init_state(family, xcols, y, init_keys(seeds, d, y.device))
    recs = {"train_mse": [], "test_mse": [], "eta": []}
    key = _first_key(cfg, seeds, y.device)
    tap_rows = []

    def record(params, f, key, alive=None):
        w = _weights(f, y, cfg, key, alive)
        recs["train_mse"].append(
            torch.mean((y - ensemble.combine(w, f)) ** 2, dim=-1))
        pred = ensemble_predict(family, params, w, xcols_test)
        recs["test_mse"].append(torch.mean((y_test - pred) ** 2, dim=-1))
        eta, rtaps = _record_eta(cfg, y[:, None, :] - f, checked=True)
        recs["eta"].append(eta)
        return w, rtaps

    params, f = state.params, state.f
    weights, _ = record(params, f, key)
    ledger = TrialLedgers.empty(y.shape[0])
    trial_bytes = [[0.0] for _ in seeds]
    for r in range(cfg.n_sweeps):
        key, k1, k2 = _split3(key)
        params, f, led2, etaps = sweep(family, cfg, params, f, xcols, y, k1,
                                       ledger, r)
        for b, (now, before) in enumerate(zip(led2.spent, ledger.spent)):
            trial_bytes[b].append(float(now - before))
        ledger = led2
        weights, rtaps = record(params, f, k2, _alive(cfg, d, r, y.device))
        if cfg.obs is not None:
            tap_rows.append({**etaps, **rtaps})
    hist = {k: torch.stack(v, dim=-1) for k, v in recs.items()}
    hist["taps"] = obs_taps.stack_tap_rows(tap_rows, axis=1)
    hist["converged_at"] = converged_record(hist["eta"], cfg.eps)
    hist["trial_bytes"] = trial_bytes
    same = all(t == trial_bytes[0] for t in trial_bytes)
    hist["bytes"] = trial_bytes[0] if same else None
    return params, f, weights, hist
