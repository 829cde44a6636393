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
           "combine", "solve_vec"]

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
