"""Closed-form inner stage of the two-stage optimization (paper eq. 10-12).

    min_a a^T A a  s.t.  1^T a = 1
        => a* = A^{-1} 1 / (1^T A^{-1} 1),   min value  eta = 1 / (1^T A^{-1} 1).

`eta_tilde` is the outer objective 1^T A^{-1} 1 that ICOA maximises (eq. 12).
Every solve against A adds the same `_JITTER * I` as the JAX package, so the
CovState engine (core.covstate) and these closed forms agree.  Each function
takes leading batch axes (..., D, D), one problem per Monte-Carlo trial.
"""
from __future__ import annotations

import torch

__all__ = ["optimal_weights", "eta", "eta_tilde", "eta_tilde_from_predictions",
           "combine", "solve_vec", "surviving_weights"]

_JITTER = 1e-10


def solve_vec(a_mat: torch.Tensor) -> torch.Tensor:
    """s = (A + jitter I)^{-1} 1: the common intermediate of
    `optimal_weights` (s normalised) and `eta_tilde` (sum s)."""
    d = a_mat.shape[-1]
    eye = torch.eye(d, dtype=a_mat.dtype, device=a_mat.device)
    ones = torch.ones((d,), dtype=a_mat.dtype, device=a_mat.device)
    return torch.linalg.solve(a_mat + _JITTER * eye, ones)


def optimal_weights(a_mat: torch.Tensor) -> torch.Tensor:
    """a* = A^{-1}1 / (1^T A^{-1} 1)   (paper eq. 10)."""
    s = solve_vec(a_mat)
    return s / torch.sum(s, dim=-1, keepdim=True)


def eta_tilde(a_mat: torch.Tensor) -> torch.Tensor:
    """1^T A^{-1} 1 — the quantity ICOA maximises (paper eq. 12)."""
    return torch.sum(solve_vec(a_mat), dim=-1)


def eta(a_mat: torch.Tensor) -> torch.Tensor:
    """Minimum ensemble training MSE = 1 / (1^T A^{-1} 1)  (paper eq. 11)."""
    return 1.0 / eta_tilde(a_mat)


def eta_tilde_from_predictions(f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """eta_tilde as a differentiable function of the agents' predictions
    f (D, N) against y (N,): what autodiff differentiates for the dense
    engine's gradient."""
    r = y[None, :] - f
    return eta_tilde((r @ r.T) / f.shape[1])


def combine(weights: torch.Tensor, predictions: torch.Tensor) -> torch.Tensor:
    """Ensemble prediction  sum_i a_i f_i:  (..., D), (..., D, N) -> (..., N)."""
    if weights.dim() == 1:
        return weights @ predictions
    return (weights[..., None, :] @ predictions)[..., 0, :]


def surviving_weights(a_mat: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Optimal weights over the alive agents only (alive (D,) bool, or one
    mask per trial): dead agents get weight exactly 0 and the rest solve
    the constrained problem on the principal submatrix (dead rows and
    columns replaced by the identity, the solution masked and
    renormalised), as the JAX package does.  Edge cases, without a
    branch on the data: a single survivor gets exactly 1; a degenerate
    solve (a sum of the solution at most the dtype's tiny) falls back to
    uniform over the survivors; no survivor, to uniform over all agents."""
    d = a_mat.shape[-1]
    alive_f = alive.to(a_mat.dtype).expand(a_mat.shape[:-1])
    n_alive = torch.sum(alive_f, dim=-1, keepdim=True)
    eye = torch.eye(d, dtype=a_mat.dtype, device=a_mat.device)
    mask2 = alive_f[..., :, None] * alive_f[..., None, :]
    a_masked = a_mat * mask2 + torch.diag_embed(1.0 - alive_f)
    s = torch.linalg.solve(a_masked + _JITTER * eye, alive_f) * alive_f
    tot = torch.sum(s, dim=-1, keepdim=True)
    solvable = torch.abs(tot) > torch.finfo(a_mat.dtype).tiny
    w = torch.where(solvable, s / torch.where(solvable, tot, torch.ones_like(tot)),
                    alive_f / torch.clamp_min(n_alive, 1.0))
    return torch.where(n_alive > 0.0, w, torch.full_like(w, 1.0 / d))
