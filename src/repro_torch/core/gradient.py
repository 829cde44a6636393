"""Gradient of the ICOA objective eta_tilde = 1^T A^{-1} 1 w.r.t. one agent's
prediction vector, off a cached inverse action (the CovState engines' form):

    grad_i = (2/m) * v_i * (v^T R_sub),   v = (A0 + jitter I)^{-1} 1.

The autodiff and from-scratch closed forms of repro.core.gradient serve the
dense engine, which waits for ROADMAP A4.
"""
from __future__ import annotations

import torch

__all__ = ["cached_row_gradient"]


def cached_row_gradient(v: torch.Tensor, r_sub: torch.Tensor, i: int,
                        exclude_self: bool = False) -> torch.Tensor:
    """Closed-form probe gradient of agent i over the transmitted positions:
    v (D,), r_sub (D, m) -> (m,), or per trial v (B, D), r_sub (B, D, m) ->
    (B, m).

    `exclude_self=True` drops the k = i term (the Sec 4.1 exact-diagonal
    split adds it separately)."""
    if v.dim() == 1:
        cross = v @ r_sub
    else:
        cross = (v[..., None, :] @ r_sub)[..., 0, :]
    vi = v[..., i, None]
    if exclude_self:
        cross = cross - vi * r_sub[..., i, :]
    return (2.0 / r_sub.shape[-1]) * vi * cross
