"""ICOA — Iterative Covariance Optimization Algorithm (paper Sec 3.1).

One sweep (the paper's inner `for i = 1..D`):

    1. gradient of eta_tilde = 1^T A^{-1} 1 w.r.t. f_i, at the current F
    2. back-tracking search for the step size
    3. f_hat_i = f_i + step * grad
    4. project onto H_i: retrain agent i's estimator with f_hat_i as outcome
    5. accept the new row only if it improves the objective, and commit it
       before moving to agent i+1

Twin of repro.core.icoa for the alpha = 1, delta = 0 slice, in PyTorch's
idiom: the agent loop is a Python loop, the back-search evaluates its whole
step schedule as one batch and takes the first improving step (the step the
JAX while_loop stops at: each probe is a pure function of its step), and
accept/reject selects with torch.where on device booleans, so the loop never
waits for the device.  Two engines compute the same sweep:

  * "incremental" (default): carries a core.covstate.CovState through the
    agent loop — closed-form gradient off the cached (A0+jitter)^{-1} 1,
    O(D^2) rank-2 SMW probes, one row-Gram product per probe and one per
    commit (kernels.gram.row_gram with use_kernel).
  * "fused": the back-search collapses to a closed-form schedule off one
    matvec, accept/commit to one fused evaluation with accept selecting the
    update; with use_kernel these two passes are kernels.sweep's probe and
    commit kernels.

`run_scan` is the Monte-Carlo building block (api.batch_fit): B independent
trials as one batched program.  Every tensor carries a leading trial axis
(B, ...) — the explicit counterpart of the JAX package's vmap over its
run_scan — and `sweep` sends such a state to the batched twins of the two
engines, where all trials update agent i together (i stays a host int) and
eta, the chosen step, accept/reject and the solve state are per trial.  With
use_kernel every product goes to the batched kernels, one launch per agent
for the whole batch.

The dense oracle engine waits for ROADMAP A4; Minimax Protection (alpha > 1,
delta > 0) for A8.  At alpha = 1 no random draw reaches the math, so `run`
carries no generator: the JAX package's per-sweep key splits feed only the
alpha > 1 subsample.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Union

import numpy as np
import torch

from repro_torch import transport as transport_lib
from repro_torch.agents.polynomial import PolynomialFamily, _features
from repro_torch.core import covariance as cov
from repro_torch.core import covstate, ensemble, gradient
from repro_torch.transport import Ledger, icoa_sweep_cost

__all__ = ["ICOAConfig", "ICOAState", "init_state", "sweep", "run",
           "run_scan", "converged_record", "ensemble_predict",
           "NotPortedError"]


class NotPortedError(NotImplementedError):
    """A configuration the JAX package supports but this port does not yet;
    the message names the ROADMAP item it waits for."""


@dataclasses.dataclass(frozen=True)
class ICOAConfig:
    n_sweeps: int = 30
    eps: float = 1e-7           # outer-loop stopping tolerance on eta
    step0: float = 1.0          # initial back-search step (scaled by sqrt(N))
    backtrack: float = 0.5      # step shrink factor
    max_probes: int = 16        # back-search budget
    alpha: float = 1.0          # compression rate (only 1 in this slice)
    delta: float = 0.0          # Minimax Protection half-width (only 0)
    use_kernel: bool = False    # route the products through kernels/
    accept_reject: bool = True  # reject projections that worsen the objective
    engine: str = "incremental"  # "incremental" | "fused"
    transport: Optional[transport_lib.Transport] = None  # None = default

    def validate(self) -> None:
        if self.alpha != 1.0 or self.delta != 0.0:
            raise NotPortedError(
                f"alpha={self.alpha}, delta={self.delta}: Minimax Protection "
                f"(alpha > 1, delta > 0) waits for ROADMAP A8")
        if self.engine == "dense":
            raise NotPortedError("engine='dense' waits for ROADMAP A4")
        if self.engine not in ("incremental", "fused"):
            raise ValueError(f"unknown engine {self.engine!r}; pick "
                             f"'incremental' or 'fused'")
        if self.max_probes < 1:
            raise ValueError("need max_probes >= 1")


@dataclasses.dataclass
class ICOAState:
    params: torch.Tensor       # (D, P) stacked agent params
    f: torch.Tensor            # (D, N) training predictions


def init_state(family, xcols: torch.Tensor, y: torch.Tensor) -> ICOAState:
    """Non-cooperative warm start: every agent fits y directly.  Batched:
    xcols (B, D, N, C), y (B, N)."""
    d, n = xcols.shape[-3], xcols.shape[-2]
    params = family.fit(None, xcols,
                        y[..., None, :].expand(*y.shape[:-1], d, n))
    return ICOAState(params=params, f=family.predict(params, xcols))


def _step_schedule(cfg: ICOAConfig, n: int, dtype: torch.dtype,
                   device) -> torch.Tensor:
    """steps[k] = step0 * backtrack^k in the data dtype, built on the host
    as the same left-associated multiply chain the JAX back-search performs
    (step0 = cfg.step0 * sqrt(N), the scale-free start)."""
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    step = np_dt(cfg.step0) * np.sqrt(np_dt(n))
    chain = [step]
    for _ in range(cfg.max_probes - 1):
        step = step * np_dt(cfg.backtrack)
        chain.append(step)
    return torch.tensor(np.asarray(chain, dtype=np_dt), device=device)


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


def sweep(family, cfg: ICOAConfig, params: torch.Tensor, f: torch.Tensor,
          xcols: torch.Tensor, y: torch.Tensor,
          ledger: Optional[Ledger] = None):
    """One full round-robin sweep over all D agents; returns
    (params, f, ledger).  The inputs are not modified.  The ledger is
    charged the row-wise schedule's bytes: the sweep-start gather plus one
    candidate-row broadcast per agent.

    A batched state — params (B, D, P), f (B, D, N), xcols (B, D, N, C),
    y (B, N) — runs all B trials through the batched engine.  Every trial
    transmits the same rows, so the ledger is charged one trial's price,
    which each trial pays alike."""
    cfg.validate()
    d, n = f.shape[-2:]
    tp = (cfg.transport or transport_lib.default_transport(d)).validate_for(d)
    ledger = (ledger or Ledger()).charge(
        icoa_sweep_cost(tp, n, split=False, row_wise=True))
    if f.dim() == 3:
        engine = (_sweep_fused_batched if cfg.engine == "fused"
                  else _sweep_incremental_batched)
    else:
        engine = _sweep_fused if cfg.engine == "fused" else _sweep_incremental
    params, f = engine(family, cfg, tp, params.clone(), f.clone(), xcols, y)
    return params, f, ledger


def _sweep_incremental(family, cfg: ICOAConfig, tp, params, f, xcols, y):
    """Rank-2 CovState engine: O(N*D + D^2) per agent update.  The CovState
    is rebuilt from f at sweep start (the once-per-sweep refresh bounding SMW
    drift); every probe and commit inside is a rank-2 update.  `params` and
    `f` are this sweep's own copies and are updated row by row."""
    d, n = f.shape
    m = n
    uk = cfg.use_kernel
    cs = covstate.build(tp.relay_rows(y[None, :] - f), use_kernel=uk)
    steps = _step_schedule(cfg, n, f.dtype, f.device)
    r_sub = cs.r_sub        # the sweep's own buffer: committed rows land in place

    for i in range(d):
        eta0 = cs.eta_tilde
        g = gradient.cached_row_gradient(cs.s, r_sub, i)
        gnorm = torch.linalg.norm(g) + 1e-30
        g_unit = g / gnorm

        # back-search: one row-Gram product, then the O(D^2) SMW probe of
        # every step of the schedule at once — the residual delta of probing
        # `step` is -step * g_unit
        p = covstate.row_product(g_unit, r_sub, use_kernel=uk) / m
        gg = torch.dot(g_unit, g_unit)
        u = -steps[:, None] * p[None, :]
        u[:, i] += steps * steps * gg / (2.0 * m)
        step = _first_improving(covstate.eta_probe(cs, i, u), eta0, steps)

        f_hat = f[i] + step * g_unit
        p_new = family.fit(params[i], xcols[i], f_hat)
        f_new = family.predict(p_new, xcols[i])

        # accept/reject and commit share one rank-2 row update; the candidate
        # row passes the codec relay before it touches the shared state
        r_new_sub = tp.relay_row(y - f_new, i)
        u_acc = covstate.row_update_vector(cs, i, r_new_sub - r_sub[i],
                                           use_kernel=uk)
        if cfg.accept_reject:
            accept = covstate.eta_probe(cs, i, u_acc) > eta0
        else:
            accept = torch.ones((), dtype=torch.bool, device=f.device)

        params[i] = torch.where(accept, p_new, params[i])
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
    return params, f


def _sweep_incremental_batched(family, cfg: ICOAConfig, tp, params, f,
                               xcols, y):
    """`_sweep_incremental` for B trials at once: one batched CovState, every
    trial updating agent i together; the step, accept/reject and the commit
    are per trial (torch.where on (B,) booleans, no host wait)."""
    d, n = f.shape[-2:]
    m = n
    uk = cfg.use_kernel
    cs = covstate.build(tp.relay_rows(y[:, None, :] - f), use_kernel=uk)
    steps = _step_schedule(cfg, n, f.dtype, f.device)
    r_sub = cs.r_sub

    for i in range(d):
        eta0 = cs.eta_tilde                                       # (B,)
        g = gradient.cached_row_gradient(cs.s, r_sub, i)          # (B, m)
        gnorm = torch.linalg.norm(g, dim=-1) + 1e-30
        g_unit = g / gnorm[:, None]

        p = covstate.row_product(g_unit, r_sub, use_kernel=uk) / m  # (B, D)
        gg = torch.sum(g_unit * g_unit, dim=-1)
        u = -steps[None, :, None] * p[:, None, :]                 # (B, K, D)
        u[:, :, i] += steps[None, :] * steps[None, :] * gg[:, None] / (2.0 * m)
        step = _first_improving_batched(covstate.eta_probe(cs, i, u), eta0,
                                        steps)

        f_hat = f[:, i] + step[:, None] * g_unit
        p_new = family.fit(params[:, i], xcols[:, i], f_hat)
        f_new = family.predict(p_new, xcols[:, i])

        r_new_sub = tp.relay_row(y - f_new, i)
        u_acc = covstate.row_update_vector(cs, i, r_new_sub - r_sub[:, i],
                                           use_kernel=uk)
        if cfg.accept_reject:
            accept = covstate.eta_probe(cs, i, u_acc) > eta0
        else:
            accept = torch.ones(eta0.shape, dtype=torch.bool, device=f.device)

        params[:, i] = torch.where(accept[:, None], p_new, params[:, i])
        f[:, i] = torch.where(accept[:, None], f_new, f[:, i])
        m_inv, s, eta_t = covstate.apply_inverse_update(cs, i, u_acc)
        a0 = cs.a0.clone()
        a0[:, i, :] += u_acc
        a0[:, :, i] += u_acc
        r_sub[:, i] = torch.where(accept[:, None], r_new_sub, r_sub[:, i])
        cs = covstate.CovState(
            r_sub=r_sub, a0=torch.where(accept[:, None, None], a0, cs.a0),
            m_inv=torch.where(accept[:, None, None], m_inv, cs.m_inv),
            s=torch.where(accept[:, None], s, cs.s),
            eta_tilde=torch.where(accept, eta_t, cs.eta_tilde))
    return params, f


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


def _sweep_fused(family, cfg: ICOAConfig, tp, params, f, xcols, y):
    """Fused engine: the incremental sweep with its back-search in closed
    form (kernels.sweep.ref.probe_etas_closed) and accept/commit as one
    evaluation with accept selecting the rank-2 update.

    With use_kernel the probe pass (cross, p, ||g||, schedule) and the commit
    pass are kernels.sweep's kernels.  Without it the probe product needs no
    pass over R at all: R @ g_unit = (2 s_i / (m gnorm)) * (A0 @ s) on the
    carried Gram.  Both branches mirror the JAX engine exactly (the kernel
    branch runs its algebra in fp32 whatever the data dtype)."""
    from repro_torch.kernels.sweep import ops as sweep_ops
    from repro_torch.kernels.sweep import ref as sweep_ref

    d, n = f.shape
    m = n
    uk = cfg.use_kernel
    dt, dev = f.dtype, f.device
    cs0 = covstate.build(tp.relay_rows(y[None, :] - f), use_kernel=uk)
    rs, a0, m_inv, s, eta = cs0.r_sub, cs0.a0, cs0.m_inv, cs0.s, cs0.eta_tilde
    steps = _step_schedule(cfg, n, dt, dev)
    zero = torch.zeros((), dtype=dt, device=dev)

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
    for i in range(d):
        eta0 = eta
        # --- probe: gradient + the whole back-search schedule ---
        if uk:
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
        p_new, f_new = project(i, params[i], f_hat)

        # --- fused accept/commit ---
        r_new_sub = tp.relay_row(y - f_new, i)
        delta = r_new_sub - rs[i]
        threshold = eta0 if cfg.accept_reject else threshold_off
        if uk:
            m_inv, s, u_eff, accept, _ = sweep_ops.commit_sweep(
                rs, m_inv, s, eta, i, delta, 1.0, 0.0, threshold, True)
        else:
            m_inv, s, u_eff, accept, _ = sweep_ref.commit_sweep_ref(
                rs, m_inv, s, eta, i, delta, 1.0, 0.0, threshold, True)
        eta = torch.sum(s)

        params[i] = torch.where(accept, p_new, params[i])
        f[i] = torch.where(accept, f_new, f[i])
        a0[i, :] += u_eff                      # u_eff = 0 on reject
        a0[:, i] += u_eff
        rs[i] = torch.where(accept, r_new_sub, rs[i])
    return params, f


def _sweep_fused_batched(family, cfg: ICOAConfig, tp, params, f, xcols, y):
    """`_sweep_fused` for B trials at once: one batched probe launch and one
    batched commit launch per agent with use_kernel, eta / threshold / the
    accept flags per trial as (B,) device tensors."""
    from repro_torch.kernels.sweep import ops as sweep_ops
    from repro_torch.kernels.sweep import ref as sweep_ref

    d, n = f.shape[-2:]
    m = n
    uk = cfg.use_kernel
    dt, dev = f.dtype, f.device
    cs0 = covstate.build(tp.relay_rows(y[:, None, :] - f), use_kernel=uk)
    rs, a0, m_inv, s, eta = cs0.r_sub, cs0.a0, cs0.m_inv, cs0.s, cs0.eta_tilde
    steps = _step_schedule(cfg, n, dt, dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    if isinstance(family, PolynomialFamily):
        phi_t, ginv = _poly_projector(xcols, family.degree, family.ridge)

        def project(i, p_old, f_hat):
            p_new = (ginv[:, i] @ (phi_t[:, i] @ f_hat[..., None]))[..., 0]
            return p_new, (p_new[:, None, :] @ phi_t[:, i])[:, 0]
    else:
        def project(i, p_old, f_hat):
            p_new = family.fit(p_old, xcols[:, i], f_hat)
            return p_new, family.predict(p_new, xcols[:, i])

    threshold_off = float("-inf")
    for i in range(d):
        eta0 = eta                                                # (B,)
        if uk:
            etas, cross, _, gnorm = sweep_ops.probe_sweep(rs, m_inv, s, eta, i,
                                                          steps)
            g_unit = ((2.0 / m) * s[:, i] / gnorm)[:, None] * cross
        else:
            g = gradient.cached_row_gradient(s, rs, i)
            gnorm = torch.linalg.norm(g, dim=-1) + 1e-30
            g_unit = g / gnorm[:, None]
            p = (2.0 * s[:, i] / (m * gnorm))[:, None] * (a0 @ s[..., None])[..., 0]
            gg = torch.sum(g_unit * g_unit, dim=-1)
            etas = sweep_ref.probe_etas_closed_batched(
                m_inv, s, eta, i, steps, p, zero, gg / (2.0 * m))
        step = _first_improving_batched(etas, eta0, steps)

        f_hat = f[:, i] + step[:, None] * g_unit
        p_new, f_new = project(i, params[:, i], f_hat)

        r_new_sub = tp.relay_row(y - f_new, i)
        delta = r_new_sub - rs[:, i]
        threshold = eta0 if cfg.accept_reject else threshold_off
        commit = sweep_ops.commit_sweep if uk else sweep_ref.commit_sweep_batched_ref
        m_inv, s, u_eff, accept, _ = commit(rs, m_inv, s, eta, i, delta, 1.0,
                                            0.0, threshold, True)
        eta = torch.sum(s, dim=-1)

        params[:, i] = torch.where(accept[:, None], p_new, params[:, i])
        f[:, i] = torch.where(accept[:, None], f_new, f[:, i])
        a0[:, i, :] += u_eff                   # u_eff = 0 on reject
        a0[:, :, i] += u_eff
        rs[:, i] = torch.where(accept[:, None], r_new_sub, rs[:, i])
    return params, f


def _weights(f: torch.Tensor, y: torch.Tensor, cfg: ICOAConfig) -> torch.Tensor:
    """Closed-form ensemble weights from the full residual covariance
    (per trial for a batched f (B, D, N), y (B, N))."""
    return ensemble.optimal_weights(cov.gram(y[..., None, :] - f,
                                             use_kernel=cfg.use_kernel))


def ensemble_predict(family, params: torch.Tensor, weights: torch.Tensor,
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


@_full_fp32
def run(family, cfg: ICOAConfig, xcols: torch.Tensor, y: torch.Tensor,
        xcols_test: Optional[torch.Tensor] = None,
        y_test: Optional[torch.Tensor] = None):
    """Full ICOA run; returns (state, weights, history dict).

    The history holds one record per sweep plus record 0 (the
    non-cooperative init): train_mse, test_mse, eta (= 1/eta_tilde of the
    record-time residual covariance) and the bytes the sweep put on the wire
    (record 0: 0).  The run stops after a sweep whose eta moved less than
    cfg.eps from the previous sweep's.  Plain float32 matrix products on the
    card stay full fp32: TF32 is off for the call (PyTorch's default) and the
    caller's setting is restored after it."""
    cfg.validate()
    state = init_state(family, xcols, y)
    hist = {"train_mse": [], "test_mse": [], "eta": [], "bytes": [0.0]}

    def record(params, f):
        w = _weights(f, y, cfg)
        hist["train_mse"].append(float(torch.mean((y - ensemble.combine(w, f)) ** 2)))
        if xcols_test is not None:
            pred = ensemble_predict(family, params, w, xcols_test)
            hist["test_mse"].append(float(torch.mean((y_test - pred) ** 2)))
        a0 = cov.subsampled_gram(y[None, :] - f, None, use_kernel=cfg.use_kernel)
        hist["eta"].append(float(1.0 / ensemble.eta_tilde(a0)))
        return w

    weights = record(state.params, state.f)
    eta_prev = math.inf
    ledger = Ledger()
    for _ in range(cfg.n_sweeps):
        params, f, led2 = sweep(family, cfg, state.params, state.f, xcols, y,
                                ledger)
        hist["bytes"].append(float(led2.spent - ledger.spent))
        ledger = led2
        state = ICOAState(params=params, f=f)
        weights = record(params, f)
        eta_now = hist["eta"][-1]
        if abs(eta_prev - eta_now) < cfg.eps:
            break
        eta_prev = eta_now
    return state, weights, hist


@_full_fp32
def run_scan(family, cfg: ICOAConfig, xcols: torch.Tensor, y: torch.Tensor,
             xcols_test: torch.Tensor, y_test: torch.Tensor):
    """B independent ICOA runs as one batched program — the Monte-Carlo
    building block (api.batch_fit), twin of the JAX package's
    `jax.vmap(run_scan)`.

    xcols (B, D, N, C), y (B, N), xcols_test (B, D, N_test, C), y_test
    (B, N_test).  Same math as `run`, but the schedule is static: exactly
    cfg.n_sweeps sweeps run and eps stops nothing.  Returns (params (B, D, P),
    f (B, D, N), weights (B, D), hist) with hist["train_mse"], ["test_mse"]
    and ["eta"] (B, n_sweeps + 1) tensors in the data dtype (record 0 is the
    non-cooperative init), hist["converged_at"] (B,) — the record where
    `run`'s eps rule would have stopped — and hist["bytes"], the host
    ledger's bytes per record (record 0: 0), the same for every trial.
    Nothing in the loop waits for the device.  TF32 is off for the call, as
    in `run`."""
    cfg.validate()
    if xcols.dim() != 4 or y.dim() != 2:
        raise ValueError(f"run_scan: expected xcols (B, D, N, C) and y (B, N), "
                         f"got {tuple(xcols.shape)} and {tuple(y.shape)}")
    state = init_state(family, xcols, y)
    recs = {"train_mse": [], "test_mse": [], "eta": []}

    def record(params, f):
        w = _weights(f, y, cfg)
        recs["train_mse"].append(
            torch.mean((y - ensemble.combine(w, f)) ** 2, dim=-1))
        pred = ensemble_predict(family, params, w, xcols_test)
        recs["test_mse"].append(torch.mean((y_test - pred) ** 2, dim=-1))
        a0 = cov.subsampled_gram(y[:, None, :] - f, None,
                                 use_kernel=cfg.use_kernel)
        recs["eta"].append(1.0 / ensemble.eta_tilde(a0))
        return w

    params, f = state.params, state.f
    weights = record(params, f)
    ledger = Ledger()
    bytes_hist = [0.0]
    for _ in range(cfg.n_sweeps):
        params, f, led2 = sweep(family, cfg, params, f, xcols, y, ledger)
        bytes_hist.append(float(led2.spent - ledger.spent))
        ledger = led2
        weights = record(params, f)
    hist = {k: torch.stack(v, dim=-1) for k, v in recs.items()}
    hist["converged_at"] = converged_record(hist["eta"], cfg.eps)
    hist["bytes"] = bytes_hist
    return params, f, weights, hist
