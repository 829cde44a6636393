"""Plain PyTorch versions of the fused sweep kernels (probe schedule + commit).

Twins of repro.kernels.sweep.ref, in the dtype of their inputs.  The fused
engine (core.icoa._sweep_fused) calls `probe_etas_closed` and
`commit_sweep_ref` directly when use_kernel is off; kernels.sweep.ops runs
`probe_sweep_ref` and `commit_sweep_ref` in fp32 as the CPU path of the
kernels, and chip_smoke.py holds the CUDA kernels against them on the card.

  * `probe_etas_closed` — the whole back-search schedule at once: the probe
    direction is fixed, so u(step) = -step * p_hat + beta(step) * e_i and
    every SMW objective probe reduces to one matvec q = m_inv @ p_hat plus
    scalar algebra per step:

        beta = c2h*step^2 + c1h*step          (alpha=1: c1h=0, c2h=gg/2m)
        k12  = 1 - step*b + beta*c            b = q_i, c = m_inv_ii
        k22  = step^2*a - 2*step*beta*b + beta^2*c      a = <p_hat, q>
        t2   = -step*e + beta*t1              e = <p_hat, s>, t1 = s_i
        det  = c*k22 - k12^2
        eta' = eta - (k22*t1^2 - 2*k12*t1*t2 + c*t2^2) / det

  * `probe_sweep_ref` — the alpha=1 probe pass: cross = s @ R, p = R @ cross
    rescaled, ||cross||^2, then the schedule.
  * `commit_sweep_ref` — row-Gram + accept/reject + symmetric rank-2 SMW
    update in one evaluation, accept selecting the update: a rejected
    candidate leaves (m_inv, s) bitwise untouched.

`probe_etas_closed` and `commit_sweep_ref` (and their batched twins) hold
the reference's check sites on their SMW pivots (analysis.sanitize); the
kernels' CPU paths call them with the sites off, as the kernels check
nothing.

The `_batched` versions compute the same for B independent Monte-Carlo
trials: every operand carries a leading trial axis (eta, threshold and can_tx
as (B,) tensors) while the step schedule is shared, and agent i is shared
(an int) or one per trial (a (B,) int64 tensor, core.trial_index).
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from repro_torch.analysis import sanitize
from repro_torch.core.trial_index import Agent, pick, put

__all__ = ["probe_etas_closed", "probe_sweep_ref", "commit_sweep_ref",
           "probe_etas_closed_batched", "probe_sweep_batched_ref",
           "commit_sweep_batched_ref"]

Scalar = Union[float, torch.Tensor]


def probe_etas_closed(m_inv: torch.Tensor, s: torch.Tensor, eta: Scalar,
                      i: int, steps: torch.Tensor, p_hat: torch.Tensor,
                      c1h: Scalar, c2h: Scalar) -> torch.Tensor:
    """eta_tilde after u(step) = -step*p_hat + (c2h*step^2 + c1h*step)*e_i,
    for every step in the schedule at once — (K,) from one O(D^2) matvec."""
    q = m_inv @ p_hat
    a = torch.dot(p_hat, q)
    b = q[i]
    c = m_inv[i, i]
    e = torch.dot(p_hat, s)
    t1 = s[i]
    beta = c2h * steps * steps + c1h * steps
    k12 = 1.0 - steps * b + beta * c
    k22 = steps * steps * a - 2.0 * steps * beta * b + beta * beta * c
    t2 = -steps * e + beta * t1
    det = c * k22 - k12 * k12
    det = sanitize.check_nonzero(
        det, "kernels.sweep probe_etas_closed: SMW pivot determinant "
        "(the whole back-search schedule divides by it)")
    return eta - (k22 * t1 * t1 - 2.0 * k12 * t1 * t2 + c * t2 * t2) / det


def probe_sweep_ref(r_sub: torch.Tensor, m_inv: torch.Tensor, s: torch.Tensor,
                    eta: Scalar, i: int, steps: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """alpha=1 fused probe pass: (etas (K,), cross (m,), p (D,), gnorm ()).

    cross = s @ R is the unnormalised gradient direction (the caller forms
    g_unit = (scale/gnorm) * cross); p = R @ g_unit / m feeds the schedule."""
    m = r_sub.shape[1]
    cross = s @ r_sub
    p_acc = r_sub @ cross                      # = m * A0 @ s
    gg_cross = torch.dot(cross, cross)
    scale = (2.0 / m) * s[i]
    gnorm = torch.sqrt(gg_cross) * torch.abs(scale) + 1e-30
    p = (scale / (m * gnorm)) * p_acc          # R @ g_unit / m
    gg = (scale / gnorm) ** 2 * gg_cross       # <g_unit, g_unit>
    etas = probe_etas_closed(m_inv, s, eta, i, steps, p,
                             torch.zeros((), dtype=p.dtype, device=p.device),
                             gg / (2.0 * m))
    return etas, cross, p, gnorm


def commit_sweep_ref(r_sub: torch.Tensor, m_inv: torch.Tensor, s: torch.Tensor,
                     eta: Scalar, i: int, delta: torch.Tensor,
                     diag_keep: Scalar, diag_add: Scalar, threshold: Scalar,
                     can_tx: Union[bool, torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor, torch.Tensor]:
    """Fused accept/commit: returns (m_inv', s', u_eff, accept, obj_post).

    u_i = diag_keep * (w_i + <delta,delta>/2m) + diag_add (alpha=1: keep=1,
    add=0).  `threshold` is the accept bar (eta0, or -inf to disable
    accept/reject); `can_tx` the transport gate."""
    m = r_sub.shape[1]
    w = (r_sub @ delta) / m
    dd_auto = torch.dot(delta, delta) / (2.0 * m)
    u = w.clone()
    u[i] = diag_keep * (w[i] + dd_auto) + diag_add

    z1 = m_inv[i]
    z2 = m_inv @ u
    k11 = m_inv[i, i]
    k12 = 1.0 + z2[i]
    k22 = torch.dot(u, z2)
    det = k11 * k22 - k12 * k12
    det = sanitize.check_nonzero(
        det, "kernels.sweep commit_sweep_ref: SMW pivot determinant "
        "(the accept probe and the rank-2 commit divide by it)")
    t1 = s[i]
    t2 = torch.dot(u, s)
    obj_post = eta - (k22 * t1 * t1 - 2.0 * k12 * t1 * t2
                      + k11 * t2 * t2) / det
    can = torch.as_tensor(can_tx, device=obj_post.device).to(torch.bool)
    accept = torch.logical_and(obj_post > threshold, can)

    zero = torch.zeros((), dtype=m_inv.dtype, device=m_inv.device)
    corr = (k22 * torch.outer(z1, z1)
            - k12 * (torch.outer(z1, z2) + torch.outer(z2, z1))
            + k11 * torch.outer(z2, z2)) / det
    m_inv_new = m_inv - torch.where(accept, corr, zero)
    c1 = torch.where(accept, (k22 * t1 - k12 * t2) / det, zero)
    c2 = torch.where(accept, (k11 * t2 - k12 * t1) / det, zero)
    s_new = s - c1 * z1 - c2 * z2
    u_eff = torch.where(accept, u, zero)
    return m_inv_new, s_new, u_eff, accept, obj_post


# ------------------------------------------------- batched over trials (B, ...)


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, D, D), (B, D) -> (B, D): one matrix-vector product per trial."""
    return (m @ v[..., None])[..., 0]


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, D), (B, D) -> (B,): one dot product per trial."""
    return torch.sum(a * b, dim=-1)


def probe_etas_closed_batched(m_inv: torch.Tensor, s: torch.Tensor,
                              eta: torch.Tensor, i: Agent, steps: torch.Tensor,
                              p_hat: torch.Tensor, c1h: Scalar,
                              c2h: Scalar) -> torch.Tensor:
    """`probe_etas_closed` per trial: m_inv (B, D, D), s and p_hat (B, D),
    eta, c1h and c2h (B,) or scalars, steps (K,) shared -> (B, K)."""
    q = _matvec(m_inv, p_hat)
    a = _vdot(p_hat, q)[:, None]
    b = pick(q, i, 1)[:, None]
    c = pick(pick(m_inv, i, 1), i, 1)[:, None]
    e = _vdot(p_hat, s)[:, None]
    t1 = pick(s, i, 1)[:, None]
    c1h = torch.as_tensor(c1h, dtype=s.dtype, device=s.device).reshape(-1, 1)
    c2h = torch.as_tensor(c2h, dtype=s.dtype, device=s.device).reshape(-1, 1)
    st = steps[None, :]
    beta = c2h * st * st + c1h * st
    k12 = 1.0 - st * b + beta * c
    k22 = st * st * a - 2.0 * st * beta * b + beta * beta * c
    t2 = -st * e + beta * t1
    det = c * k22 - k12 * k12
    det = sanitize.check_nonzero(
        det, "kernels.sweep probe_etas_closed: SMW pivot determinant "
        "(the whole back-search schedule divides by it)")
    eta = torch.as_tensor(eta, dtype=s.dtype, device=s.device).reshape(-1, 1)
    return eta - (k22 * t1 * t1 - 2.0 * k12 * t1 * t2 + c * t2 * t2) / det


def probe_sweep_batched_ref(r_sub: torch.Tensor, m_inv: torch.Tensor,
                            s: torch.Tensor, eta: Scalar, i: Agent,
                            steps: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """`probe_sweep_ref` per trial: r_sub (B, D, m), m_inv (B, D, D),
    s (B, D), eta (B,) -> (etas (B, K), cross (B, m), p (B, D), gnorm (B,))."""
    m = r_sub.shape[-1]
    cross = (s[:, None, :] @ r_sub)[:, 0]
    p_acc = _matvec(r_sub, cross)              # = m * A0 @ s
    gg_cross = _vdot(cross, cross)
    scale = (2.0 / m) * pick(s, i, 1)
    gnorm = torch.sqrt(gg_cross) * torch.abs(scale) + 1e-30
    p = (scale / (m * gnorm))[:, None] * p_acc  # R @ g_unit / m
    gg = (scale / gnorm) ** 2 * gg_cross       # <g_unit, g_unit>
    etas = probe_etas_closed_batched(m_inv, s, eta, i, steps, p, 0.0,
                                     gg / (2.0 * m))
    return etas, cross, p, gnorm


def commit_sweep_batched_ref(r_sub: torch.Tensor, m_inv: torch.Tensor,
                             s: torch.Tensor, eta: Scalar, i: Agent,
                             delta: torch.Tensor, diag_keep: Scalar,
                             diag_add: Scalar, threshold: Scalar,
                             can_tx: Union[bool, torch.Tensor]
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """`commit_sweep_ref` per trial: r_sub (B, D, m), m_inv (B, D, D),
    s (B, D), delta (B, m); eta, threshold and can_tx (B,) or scalars ->
    (m_inv' (B, D, D), s' (B, D), u_eff (B, D), accept (B,), obj_post (B,)).
    A rejected trial keeps its m_inv and s bitwise."""
    m = r_sub.shape[-1]
    w = _matvec(r_sub, delta) / m
    dd_auto = _vdot(delta, delta) / (2.0 * m)
    u = w.clone()
    put(u, i, 1, diag_keep * (pick(w, i, 1) + dd_auto) + diag_add)

    z1 = pick(m_inv, i, 1)
    z2 = _matvec(m_inv, u)
    k11 = pick(z1, i, 1)
    k12 = 1.0 + pick(z2, i, 1)
    k22 = _vdot(u, z2)
    det = k11 * k22 - k12 * k12
    det = sanitize.check_nonzero(
        det, "kernels.sweep commit_sweep_ref: SMW pivot determinant "
        "(the accept probe and the rank-2 commit divide by it)")
    t1 = pick(s, i, 1)
    t2 = _vdot(u, s)
    obj_post = eta - (k22 * t1 * t1 - 2.0 * k12 * t1 * t2
                      + k11 * t2 * t2) / det
    can = torch.as_tensor(can_tx, device=obj_post.device).to(torch.bool)
    accept = torch.logical_and(obj_post > threshold, can)

    def outer(a, b):
        return a[:, :, None] * b[:, None, :]

    zero = torch.zeros((), dtype=m_inv.dtype, device=m_inv.device)
    corr = (k22[:, None, None] * outer(z1, z1)
            - k12[:, None, None] * (outer(z1, z2) + outer(z2, z1))
            + k11[:, None, None] * outer(z2, z2)) / det[:, None, None]
    m_inv_new = m_inv - torch.where(accept[:, None, None], corr, zero)
    c1 = torch.where(accept, (k22 * t1 - k12 * t2) / det, zero)
    c2 = torch.where(accept, (k11 * t2 - k12 * t1) / det, zero)
    s_new = s - c1[:, None] * z1 - c2[:, None] * z2
    u_eff = torch.where(accept[:, None], u, zero)
    return m_inv_new, s_new, u_eff, accept, obj_post
