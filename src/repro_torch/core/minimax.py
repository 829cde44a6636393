"""Minimax Protection (paper Sec 4): robust ensemble weights under covariance
uncertainty, the delta_opt(alpha) rule and the eq. 28 test-error bound.

Twin of repro.core.minimax.  The adversary's inner maximisation over the
entry-wise box is closed form (eq. 22), which leaves (eq. 24/25)

    min_a  a^T A0 a - delta sum_i a_i^2 + delta (sum_i |a_i|)^2
    s.t.   1^T a = 1,

solved by projected subgradient descent from the closed-form weights of the
unprotected problem.  `robust_weights` is the JAX package's lax.scan step
for step — the same gradient (jax.grad's, whose derivative of |a_i| is +1
at a_i = 0), the same lr / (1 + 0.02 t) schedule with t in the data dtype,
the same re-projection and the same best-iterate rule — as a Python loop
over tensors with any leading axes (..., D): one call solves a whole trial
batch, or every probe of a back-search schedule, at once.  Selections are
torch.where on device booleans, so the loop never waits for the device.

On the card the loop's ~10^4 small launches would keep the host busy for
~0.1 s a solve while the device idles, so its iterations run as one CUDA
graph, recorded at the first call of each (shape, dtype, device, delta,
steps, lr) and replayed after: the same kernels on the same inputs.
"""
from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis import recompile
from repro_torch.core import covariance as cov
from repro_torch.core import ensemble

__all__ = ["robust_objective", "robust_weights", "delta_opt", "upper_bound"]


def _quad_left(a: torch.Tensor, a0: torch.Tensor) -> torch.Tensor:
    """a @ A0 per problem: (..., D), (..., D, D) -> (..., D)."""
    return (a[..., None, :] @ a0)[..., 0, :]


def _objective(a: torch.Tensor, a_a0: torch.Tensor, l1: torch.Tensor,
               delta: float) -> torch.Tensor:
    """eq. 24 from its pieces a @ A0 and sum |a| (shared with the gradient)."""
    quad = torch.sum(a_a0 * a, dim=-1)
    return (quad - delta * torch.sum(a * a, dim=-1)) + (delta * l1) * l1


def robust_objective(a: torch.Tensor, a0: torch.Tensor,
                     delta: float) -> torch.Tensor:
    """Worst-case ensemble MSE over the box C (paper eq. 24), per problem:
    (..., D), (..., D, D) -> (...)."""
    return _objective(a, _quad_left(a, a0), torch.sum(torch.abs(a), dim=-1),
                      delta)


def robust_weights(a0: torch.Tensor, delta: float, steps: int = 300,
                   lr: float = 0.05,
                   a_init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Projected (sub)gradient descent on eq. 24 with 1^T a = 1, for A0
    (..., D, D); returns the best iterate (..., D).

    Starts at the unprotected closed form a*(A0) unless `a_init` is given
    (the incremental engine passes its cached solve, normalised), falling
    back to uniform weights where the start is not finite or has an entry
    of magnitude 1e3 or more (an indefinite subsampled A0)."""
    d = a0.shape[-1]
    if a_init is None:
        a_init = ensemble.optimal_weights(a0)
    tame = torch.isfinite(a_init).all(dim=-1, keepdim=True) & (
        torch.amax(torch.abs(a_init), dim=-1, keepdim=True) < 1e3)
    a = torch.where(tame, a_init, torch.full_like(a_init, 1.0 / d))
    if a0.is_cuda:
        return _descend_graphed(a0, a, delta, steps, lr)
    return _descend(a0, a, delta, steps, lr)


def _descend(a0: torch.Tensor, a: torch.Tensor, delta: float, steps: int,
             lr: float) -> torch.Tensor:
    """`steps` projected subgradient steps from a (on the plane sum = 1);
    returns the best iterate, a itself if none beats it."""
    d = a0.shape[-1]
    a0_t = a0.mT
    np_dt = np.float64 if a0.dtype == torch.float64 else np.float32
    # the step's denominators 1 + 0.02 t in the data dtype, as the JAX scan
    # forms them; a Python float holding each exactly
    denom = [float(np_dt(1.0) + np_dt(0.02) * np_dt(t)) for t in range(steps)]

    a_a0 = _quad_left(a, a0)
    l1 = torch.sum(torch.abs(a), dim=-1, keepdim=True)
    best_a = a
    best_v = _objective(a, a_a0, l1[..., 0], delta)
    for t in range(steps):
        # jax.grad of eq. 24, summed in its order: -2 delta a, then the
        # +-2 delta |a|_1 subgradient (+ where a >= 0), then a @ A0, A0 @ a
        z = a * (-2.0 * delta)
        tv = l1 * (2.0 * delta)
        g = z + torch.where(a >= 0, tv, -tv)
        g = (g + a_a0) + (a[..., None, :] @ a0_t)[..., 0, :]
        g = g - torch.mean(g, dim=-1, keepdim=True)
        a = a - (lr * g) / denom[t]
        a = a - (torch.sum(a, dim=-1, keepdim=True) - 1.0) / d
        a_a0 = _quad_left(a, a0)
        l1 = torch.sum(torch.abs(a), dim=-1, keepdim=True)
        v = _objective(a, a_a0, l1[..., 0], delta)
        better = v < best_v
        best_a = torch.where(better[..., None], a, best_a)
        best_v = torch.where(better, v, best_v)
    return best_a


_GRAPHS: "collections.OrderedDict" = collections.OrderedDict()
_GRAPHS_KEPT = 16


def _descend_graphed(a0: torch.Tensor, a: torch.Tensor, delta: float,
                     steps: int, lr: float) -> torch.Tensor:
    """`_descend` on the card as a CUDA graph replay: recorded on static
    copies of its inputs at the first call of a (shape, dtype, device,
    delta, steps, lr, TF32 switch), replayed on the current stream after the
    inputs are copied in; the last _GRAPHS_KEPT graphs are kept.  The TF32
    switch is part of the key because a graph replays the matmul kernels it
    recorded, whatever the switch says at the replay.  Each capture is
    counted for the compile and capture auditor (analysis.recompile)."""
    key = (tuple(a0.shape), a0.dtype, a0.device, float(delta), steps, float(lr),
           torch.backends.cuda.matmul.allow_tf32)
    entry = _GRAPHS.get(key)
    if entry is None:
        with torch.cuda.device(a0.device):
            a0_in, a_in = a0.clone(memory_format=torch.contiguous_format), a.clone()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):       # warm-up: allocator, cuBLAS state
                _descend(a0_in, a_in, delta, steps, lr)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = _descend(a0_in, a_in, delta, steps, lr)
            recompile.record("capture:minimax._descend_graphed")
        entry = _GRAPHS[key] = (graph, a0_in, a_in, out)
        if len(_GRAPHS) > _GRAPHS_KEPT:
            _GRAPHS.popitem(last=False)
    else:
        _GRAPHS.move_to_end(key)
    graph, a0_in, a_in, out = entry
    a0_in.copy_(a0)
    a_in.copy_(a)
    graph.replay()
    return out.clone()


def _t975(nu: float) -> float:
    """97.5th percentile of Student's t with nu dof (the JAX package's
    rational approximation)."""
    nu = max(nu, 1.0)
    return 1.96 + 2.4 / nu + 5.2 / (nu * nu)


def delta_opt(alpha: float, n: int, sigma_max_sq: float,
              t_correct: bool = False) -> float:
    """Paper eq. 27: min{1.96 sigma_max^2 / sqrt(m), 2 sigma_max^2} with
    m = covariance.subsample_size(n, alpha); t_correct substitutes the
    t_{m-2} quantile for 1.96."""
    m = cov.subsample_size(n, alpha)
    factor = _t975(m - 2) if t_correct else 1.96
    return float(min(factor * sigma_max_sq / m ** 0.5, 2.0 * sigma_max_sq))


def upper_bound(a_ini: torch.Tensor, alpha: float, n: int, steps: int = 300,
                lr: float = 0.05) -> float:
    """Eq. 28: the high-probability bound on the ensemble test error at rate
    alpha — the protected problem's optimum at delta_opt(alpha) on the
    accurate covariance `a_ini` of the pre-ICOA residuals."""
    sigma_max_sq = float(torch.max(torch.diagonal(a_ini)))
    d = delta_opt(alpha, n, sigma_max_sq)
    a = robust_weights(a_ini, d, steps=steps, lr=lr)
    return float(robust_objective(a, a_ini, d))
