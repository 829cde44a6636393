"""Incremental covariance engine: rank-2 row updates of the ICOA solve state.

Only agent i's residual row changes per update, so A moves by a symmetric
rank-2 perturbation A' = A + e_i u^T + u e_i^T and the cached inverse action
follows by Sherman-Morrison-Woodbury in O(D^2).  `CovState` carries what a
sweep needs:

    r_sub      (D, m) transmitted residual rows (m = N at alpha = 1)
    a0         (D, D) covariance estimate
    m_inv      (D, D) inverse of (a0 + jitter I), symmetrised
    s          (D,)   m_inv @ 1
    eta_tilde  ()     sum(s), the ICOA objective

`eta_probe`/`s_probe` evaluate a hypothetical row change without committing
(the back-search's probes; a leading batch axis on u probes a whole step
schedule at once); `apply_row_update` commits one.  The one O(N*D) product
per probe and per commit runs through kernels.gram.row_gram when
`use_kernel` is set.

A CovState may also carry a leading Monte-Carlo trial axis: r_sub (B, D, m),
a0 and m_inv (B, D, D), s (B, D), eta_tilde (B,) — the twin of the JAX
package's covstate under the trial vmap.  `build`, `row_product`,
`row_update_vector`, `eta_probe`, `s_probe`, `robust_eta_probe` and
`apply_inverse_update` take such a state, with agent i shared by the batch
(every trial updates the same agent at the same time) or, where a budget
policy orders each trial's agents (transport.policy.greedy_order), one
agent per trial as a (B,) int64 device tensor; u of shape (B, D), or
(B, K, D) for a step schedule (core.trial_index indexes such an agent).

Under Minimax Protection (alpha > 1) `build(exact_diag=)` splices the exact
local variances into the subsample's Gram (Sec 4.1) and
`row_update_vector(ddiag=)` moves that diagonal by its exact change;
`robust_eta_probe` is the protected twin of `eta_probe`.

`replace_cols` swaps a run of instance columns of r_sub (the stream's
commit of a chunk, repro_torch.stream; `replace_col` one): per arrival one
Sherman–Morrison update for the arriving column and one downdate for the
evicted one, O(D^2) with no pass over the window.  Twin of
repro.core.covstate.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.analysis import sanitize
from repro_torch.core import covariance as cov
from repro_torch.core import minimax
from repro_torch.core.ensemble import _JITTER
from repro_torch.core.trial_index import add_at, pick, put

__all__ = ["CovState", "build", "refresh", "row_product", "row_update_vector",
           "eta_probe", "s_probe", "robust_eta_probe", "apply_inverse_update",
           "apply_row_update", "replace_col", "replace_cols"]

class CovState(NamedTuple):
    r_sub: torch.Tensor       # (D, m) residual matrix view (transmitted rows)
    a0: torch.Tensor          # (D, D) covariance
    m_inv: torch.Tensor       # (D, D) = (a0 + jitter I)^{-1}
    s: torch.Tensor           # (D,)   = m_inv @ 1
    eta_tilde: torch.Tensor   # ()     = sum(s)


def row_product(vec: torch.Tensor, r_sub: torch.Tensor,
                use_kernel: bool = False) -> torch.Tensor:
    """(m,), (D, m) -> (D,) = R @ vec — the engine's one O(N*D) product;
    per trial (B, m), (B, D, m) -> (B, D).  Kernel path: fp32 accumulation,
    cast back to the residual dtype."""
    if use_kernel:
        from repro_torch.kernels.gram import ops as gram_ops

        return gram_ops.row_gram(vec, r_sub).to(r_sub.dtype)
    if r_sub.dim() == 3:
        return (r_sub @ vec[..., None])[..., 0]
    return r_sub @ vec


def _with_solve(r_sub: torch.Tensor, a0: torch.Tensor) -> CovState:
    d = a0.shape[-1]
    eye = torch.eye(d, dtype=a0.dtype, device=a0.device)
    m_inv = torch.linalg.inv(a0 + _JITTER * eye)
    # the SMW update assumes exact symmetry; linalg.inv returns column-major
    # strides, and the kernels read row-major contiguous memory
    m_inv = (0.5 * (m_inv + m_inv.mT)).contiguous()
    s = m_inv @ torch.ones((d,), dtype=a0.dtype, device=a0.device)
    return CovState(r_sub=r_sub, a0=a0, m_inv=m_inv, s=s,
                    eta_tilde=torch.sum(s, dim=-1))


def build(r_sub: torch.Tensor, exact_diag: Optional[torch.Tensor] = None,
          use_kernel: bool = False) -> CovState:
    """Full O(N*D^2 + D^3) construction — the once-per-sweep refresh.
    `exact_diag` (sum(r_i^2)/N over the FULL residuals, (D,) or (B, D))
    activates the Sec 4.1 split: off-diagonals from the transmitted
    subsample, diagonal exact."""
    if exact_diag is not None:
        a0 = cov.spliced_gram(r_sub, exact_diag, use_kernel=use_kernel)
    else:
        a0 = cov.gram(r_sub, use_kernel=use_kernel)
    return _with_solve(r_sub, a0)


def refresh(state: CovState) -> CovState:
    """Re-solve m_inv/s from a0, discarding accumulated SMW drift."""
    return _with_solve(state.r_sub, state.a0)


def row_update_vector(state: CovState, i: int, delta_sub: torch.Tensor,
                      ddiag: Optional[torch.Tensor] = None,
                      use_kernel: bool = False) -> torch.Tensor:
    """u with A0' = A0 + e_i u^T + u e_i^T after row i's residual moves by
    delta_sub.  `ddiag=None` means the diagonal comes from the same Gram as
    the off-diagonals (alpha = 1); otherwise it is the change of the exact
    local diagonal (Sec 4.1 split).  One row_gram product — O(N*D).  Per
    trial: delta_sub (B, m), ddiag (B,) -> u (B, D)."""
    m = state.r_sub.shape[-1]
    w = row_product(delta_sub, state.r_sub, use_kernel=use_kernel) / m
    if ddiag is not None:
        put(w, i, -1, 0.5 * ddiag)
    elif delta_sub.dim() == 2:
        add_at(w, i, 1, torch.sum(delta_sub * delta_sub, dim=-1) / (2.0 * m))
    else:
        w[i] += torch.dot(delta_sub, delta_sub) / (2.0 * m)
    return w


def _smw_pieces(state: CovState, i: int, u: torch.Tensor):
    """Shared algebra of (A0' + jitter I)^{-1} = M - Z K^{-1} Z^T with
    Z = M [e_i, u] and K = C^{-1} + [e_i, u]^T M [e_i, u].  u may carry
    leading batch axes (..., D); the pieces then carry them too."""
    z1 = state.m_inv[i]                          # M e_i (M symmetric)
    z2 = u @ state.m_inv.T                       # M u, row by row
    k11 = state.m_inv[i, i]
    k12 = 1.0 + z2[..., i]
    k22 = torch.sum(u * z2, dim=-1)
    det = k11 * k22 - k12 * k12
    det = sanitize.check_nonzero(
        det, "covstate._smw_pieces: SMW pivot determinant "
        "(eta_probe / s_probe / apply_row_update divide by it)")
    return z1, z2, k11, k12, k22, det


def _smw_pieces_batched(state: CovState, i: int, u: torch.Tensor):
    """`_smw_pieces` per trial: u (B, K, D) against m_inv (B, D, D); the
    per-trial scalars come back (B, 1) and the per-probe ones (B, K)."""
    m_inv = state.m_inv
    z1 = pick(m_inv, i, 1)                       # (B, D): M e_i
    z2 = u @ m_inv.mT                            # (B, K, D): M u, row by row
    k11 = pick(z1, i, 1)[:, None]
    k12 = 1.0 + pick(z2, i, -1)
    k22 = torch.sum(u * z2, dim=-1)
    det = k11 * k22 - k12 * k12
    det = sanitize.check_nonzero(
        det, "covstate._smw_pieces: SMW pivot determinant "
        "(eta_probe / s_probe / apply_row_update divide by it)")
    return z1, z2, k11, k12, k22, det


def _eta_probe_batched(state: CovState, i: int, u: torch.Tensor) -> torch.Tensor:
    u3 = u if u.dim() == 3 else u[:, None, :]
    _, _, k11, k12, k22, det = _smw_pieces_batched(state, i, u3)
    t1 = pick(state.s, i, 1)[:, None]
    t2 = (u3 @ state.s[..., None])[..., 0]
    eta = state.eta_tilde[:, None] - (k22 * t1 * t1 - 2.0 * k12 * t1 * t2
                                      + k11 * t2 * t2) / det
    return eta if u.dim() == 3 else eta[:, 0]


def eta_probe(state: CovState, i: int, u: torch.Tensor) -> torch.Tensor:
    """eta_tilde after a hypothetical row-i update u (..., D) — O(D^2) each,
    no commit.  A batched state takes u (B, D) -> (B,) or (B, K, D) ->
    (B, K)."""
    if state.m_inv.dim() == 3:
        return _eta_probe_batched(state, i, u)
    _, _, k11, k12, k22, det = _smw_pieces(state, i, u)
    t1, t2 = state.s[i], u @ state.s
    return state.eta_tilde - (k22 * t1 * t1 - 2.0 * k12 * t1 * t2
                              + k11 * t2 * t2) / det


def s_probe(state: CovState, i: int, u: torch.Tensor) -> torch.Tensor:
    """(A0' + jitter I)^{-1} 1 after a hypothetical row-i update u (..., D)
    -> (..., D); a batched state takes u (B, D) or (B, K, D)."""
    if state.m_inv.dim() == 3:
        u3 = u if u.dim() == 3 else u[:, None, :]
        z1, z2, k11, k12, k22, det = _smw_pieces_batched(state, i, u3)
        t1 = pick(state.s, i, 1)[:, None]
        t2 = (u3 @ state.s[..., None])[..., 0]
        z1 = z1[:, None, :]
        s = state.s[:, None, :]
    else:
        z1, z2, k11, k12, k22, det = _smw_pieces(state, i, u)
        t1, t2 = state.s[i], u @ state.s
        s = state.s
    c1 = (k22 * t1 - k12 * t2) / det
    c2 = (k11 * t2 - k12 * t1) / det
    sp = s - c1[..., None] * z1 - c2[..., None] * z2
    return sp if state.m_inv.dim() == 2 or u.dim() == 3 else sp[:, 0]


def robust_eta_probe(state: CovState, i: int, u: torch.Tensor, delta: float,
                     steps: int, lr: float) -> torch.Tensor:
    """Minimax-protected objective (-zeta, paper eq. 24) after a
    hypothetical row-i update u — the protected twin of `eta_probe`, for u
    (..., D) of a single state or (B, D) / (B, K, D) of a batched one: a*
    is re-solved on each perturbed A0, warm-started from the SMW solve
    instead of a fresh O(D^3) factorisation, all probes in one
    robust_weights call."""
    a0 = state.a0
    if a0.dim() == 3 and u.dim() == 3:
        a0 = a0[:, None]
    a0p = a0.expand(*u.shape[:-1], *a0.shape[-2:]).clone()
    add_at(a0p, i, -2, u)
    add_at(a0p, i, -1, u)                 # (i, i) gains 2 u_i, as in JAX
    sp = s_probe(state, i, u)
    ap = minimax.robust_weights(a0p, delta, steps=steps, lr=lr,
                                a_init=sp / torch.sum(sp, dim=-1, keepdim=True))
    return -minimax.robust_objective(ap, a0p, delta)


def _apply_inverse_update_batched(state: CovState, i: int, u: torch.Tensor):
    z1, z2, k11, k12, k22, det = _smw_pieces_batched(state, i, u[:, None, :])
    z2, k12, k22, det = z2[:, 0], k12[:, 0], k22[:, 0], det[:, 0]
    k11 = k11[:, 0]

    def outer(a, b):
        return a[:, :, None] * b[:, None, :]

    m_inv = state.m_inv - (k22[:, None, None] * outer(z1, z1)
                           - k12[:, None, None] * (outer(z1, z2) + outer(z2, z1))
                           + k11[:, None, None] * outer(z2, z2)) / det[:, None, None]
    t1 = pick(state.s, i, 1)
    t2 = torch.sum(u * state.s, dim=-1)
    c1 = (k22 * t1 - k12 * t2) / det
    c2 = (k11 * t2 - k12 * t1) / det
    s = state.s - c1[:, None] * z1 - c2[:, None] * z2
    return m_inv, s, torch.sum(s, dim=-1)


def apply_inverse_update(state: CovState, i: int, u: torch.Tensor):
    """(m_inv', s', eta_tilde') after the rank-2 row-i perturbation u; a
    batched state takes u (B, D), one perturbation per trial."""
    if state.m_inv.dim() == 3:
        return _apply_inverse_update_batched(state, i, u)
    z1, z2, k11, k12, k22, det = _smw_pieces(state, i, u)
    m_inv = state.m_inv - (k22 * torch.outer(z1, z1)
                           - k12 * (torch.outer(z1, z2) + torch.outer(z2, z1))
                           + k11 * torch.outer(z2, z2)) / det
    t1, t2 = state.s[i], torch.dot(u, state.s)
    c1 = (k22 * t1 - k12 * t2) / det
    c2 = (k11 * t2 - k12 * t1) / det
    s = state.s - c1 * z1 - c2 * z2
    return m_inv, s, torch.sum(s)


def apply_row_update(state: CovState, i: int, r_new_sub: torch.Tensor,
                     u: torch.Tensor) -> CovState:
    """Commit a row change whose update vector u is already in hand — O(D^2)
    plus one row copy.  Returns a new state; `state` is left as it was."""
    a0 = state.a0.clone()
    a0[i, :] += u
    a0[:, i] += u                    # (i, i) gains 2 u_i: correct
    m_inv, s, eta = apply_inverse_update(state, i, u)
    r_sub = state.r_sub.clone()
    r_sub[i] = r_new_sub
    return CovState(r_sub=r_sub, a0=a0, m_inv=m_inv, s=s, eta_tilde=eta)


def _rank1_inverse_update(m_inv: torch.Tensor, s: torch.Tensor,
                          v: torch.Tensor, sign: float):
    """(m_inv', s') after A0 += sign * v v^T — one Sherman–Morrison step.
    m_inv is symmetric, so w = M v serves both sides of the correction and
    s' = M' 1 follows from the same pieces; sign is +1 (update) or -1
    (downdate)."""
    w = m_inv @ v
    vw = torch.dot(v, w)
    denom = 1.0 + vw if sign > 0 else 1.0 - vw    # 1 + sign * v.w, exactly
    denom = sanitize.check_nonzero(
        denom, "covstate._rank1_inverse_update: Sherman-Morrison pivot "
        "(replace_col divides by it; an exactly-singular downdate means the "
        "evicted instance carried the whole window's mass)")
    coef = sign / denom
    return m_inv - coef * torch.outer(w, w), s - (coef * torch.dot(v, s)) * w


def replace_cols(state: CovState, j0: int, c_new: torch.Tensor) -> CovState:
    """Replace instance columns j0 .. j0 + n - 1 of r_sub (D, m) by c_new
    (D, n): the stream's commit of n arrivals, O(n D^2) with no pass over
    the window, equal to n successive one-column swaps.

    Each arrival is one rank-1 update of A0 = r r^T / m for the arriving
    column and one rank-1 downdate for the evicted one, two Sherman–Morrison
    steps on (m_inv, s) in arrival order; A0 takes the n columns' change in
    one product.  A zero outgoing column (the ring's empty slot during
    warm-up) leaves its downdate an exact no-op (w = 0, so m_inv and s are
    unchanged), so append and evict-replace are one operation.  The slots
    are distinct and do not wrap (j0 + n <= m).  The alpha = 1 state only
    (no spliced diagonal).  Returns a new state; `state` is left as it
    was."""
    n, m = c_new.shape[-1], state.r_sub.shape[-1]
    if j0 + n > m:
        raise ValueError(f"columns {j0}..{j0 + n - 1} run past the window "
                         f"of {m}")
    inv_sqrt_m = 1.0 / math.sqrt(m)
    c_old = state.r_sub[:, j0:j0 + n]
    v_new, v_old = c_new * inv_sqrt_m, c_old * inv_sqrt_m
    m_inv, s = state.m_inv, state.s
    for t in range(n):
        m_inv, s = _rank1_inverse_update(m_inv, s, v_new[:, t], 1.0)
        m_inv, s = _rank1_inverse_update(m_inv, s, v_old[:, t], -1.0)
    a0 = state.a0 + (c_new @ c_new.T - c_old @ c_old.T) / m
    r_sub = state.r_sub.clone()
    r_sub[:, j0:j0 + n] = c_new
    return CovState(r_sub=r_sub, a0=a0, m_inv=m_inv, s=s, eta_tilde=torch.sum(s))


def replace_col(state: CovState, j: int, c_new: torch.Tensor) -> CovState:
    """Replace instance column j of r_sub by c_new (D,): `replace_cols` of
    one arrival."""
    return replace_cols(state, j, c_new[:, None])
