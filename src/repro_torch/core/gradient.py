"""Gradient of the ICOA objective eta_tilde = 1^T A^{-1} 1 w.r.t. one agent's
prediction vector f_i (twin of repro.core.gradient).

Three forms of the same derivative:

  * `agent_gradient` / `all_agent_gradients` — reverse-mode autodiff
    (torch.autograd) through the covariance assembly and the linear solve:
    the dense engine's gradient;
  * `closed_form_gradient` — the matrix-calculus closed form

        d eta / d f_i = (2/N) s_i (s^T R),   s = A^{-1} 1,  R = y - F,

    which the tests hold autodiff to;
  * `cached_row_gradient` — the same closed form off a cached inverse
    action, over the transmitted positions: the CovState engines' form.
"""
from __future__ import annotations

import torch

from repro_torch.core.ensemble import eta_tilde_from_predictions
from repro_torch.core.trial_index import pick

__all__ = ["agent_gradient", "all_agent_gradients", "closed_form_gradient",
           "cached_row_gradient"]


def agent_gradient(f: torch.Tensor, y: torch.Tensor, i: int) -> torch.Tensor:
    """d eta_tilde / d f_i via autodiff; f (D, N) -> (N,)."""
    fi = f[i].detach().clone().requires_grad_(True)
    ff = torch.cat([f[:i].detach(), fi[None], f[i + 1:].detach()])
    return torch.autograd.grad(eta_tilde_from_predictions(ff, y), fi)[0]


def all_agent_gradients(f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """d eta_tilde / d F for all agents at once; (D, N)."""
    ff = f.detach().clone().requires_grad_(True)
    return torch.autograd.grad(eta_tilde_from_predictions(ff, y), ff)[0]


def closed_form_gradient(f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """grad_i = (2/N) s_i (s^T R),  s = (A + 1e-10 I)^{-1} 1,  A = R R^T / N;
    (D, N)."""
    d, n = f.shape
    r = y[None, :] - f
    a_mat = (r @ r.T) / n
    eye = torch.eye(d, dtype=a_mat.dtype, device=a_mat.device)
    s = torch.linalg.solve(a_mat + 1e-10 * eye,
                           torch.ones((d,), dtype=a_mat.dtype, device=a_mat.device))
    return (2.0 / n) * s[:, None] * (s @ r)[None, :]


def cached_row_gradient(v: torch.Tensor, r_sub: torch.Tensor, i: int,
                        exclude_self: bool = False) -> torch.Tensor:
    """Closed-form probe gradient of agent i over the transmitted positions:
    v (D,), r_sub (D, m) -> (m,), or per trial v (B, D), r_sub (B, D, m) ->
    (B, m), agent i shared or one per trial (core.trial_index).  v is the
    cached s = (A0 + jitter I)^{-1} 1, or the robust
    weights a* under Minimax Protection (the Danskin term has the same
    shape).

    `exclude_self=True` drops the k = i term: under the Sec 4.1 split A0_ii
    is the exact local variance, independent of the subsample, and the
    caller adds its term (2/N) v_i^2 r_i separately."""
    if v.dim() == 1:
        cross = v @ r_sub
    else:
        cross = (v[..., None, :] @ r_sub)[..., 0, :]
    vi = pick(v, i, -1)[..., None]
    if exclude_self:
        cross = cross - vi * pick(r_sub, i, -2)
    return (2.0 / r_sub.shape[-1]) * vi * cross
