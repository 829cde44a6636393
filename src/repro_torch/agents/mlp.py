"""Small MLP agents — a non-linear, non-closed-form hypothesis space (twin
of repro.agents.mlp).

The ICOA projection ("train with f_hat as the outcome") is approximate:
`fit_steps` full-batch Adam steps, warm-started from the current
parameters, the stand-in of the paper's CART trees.  Params are a dict —
w1 (C, H), b1 (H,), w2 (H, H), b2 (H,), w3 (H, 1), b3 (1,) — with the JAX
package's dtypes: the weights in the draw's dtype (float64 under
jax_enable_x64), the biases float32 always, and Adam's moments in each
leaf's own dtype; the step count's bias corrections are formed in the
run's float dtype and cast to each leaf's, as the JAX package's weakly
typed step counter is.

Every leaf takes leading batch axes, agents and trials alike (w1
(..., C, H) with x (..., N, C) and target (..., N)).  The gradients are
torch.autograd's of the agents' losses summed: each agent's loss depends
on its own parameters only, so each gets its exact gradient, with no loop
over agents.  The family keeps no state between calls.  Adam's steps take
XLA's roundings (the moments' decays as fused multiply-adds, square roots
rounded once), but XLA's tanh differs from torch's in the last bits and
the loss sums over N in another order, so the fits agree with the JAX
package's within its own one-ulp spread, not bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch import prng
from repro_torch.data import libm

__all__ = ["MLPFamily"]

_NP = {torch.float32: np.float32, torch.float64: np.float64}


def _forward(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    h = torch.tanh(x @ params["w1"] + params["b1"][..., None, :])
    h = torch.tanh(h @ params["w2"] + params["b2"][..., None, :])
    return (h @ params["w3"] + params["b3"][..., None, :])[..., 0]


@dataclasses.dataclass(frozen=True)
class MLPFamily:
    n_cols: int
    hidden: int = 32
    fit_steps: int = 200
    lr: float = 3e-2

    def init(self, key: torch.Tensor,
             dtype: torch.dtype = None) -> Dict[str, torch.Tensor]:
        """Params for keys (..., 2): split(key, 3) and jax.random.normal
        weights scaled by 1/sqrt(fan-in), in `dtype` (torch's default
        float dtype, as the JAX package draws in jax's), zero float32
        biases."""
        dt = torch.get_default_dtype() if dtype is None else dtype
        k1, k2, k3 = prng.split(key, 3).unbind(-2)
        c, h = self.n_cols, self.hidden
        lead = key.shape[:-1]

        def zeros(n):
            return torch.zeros((*lead, n), dtype=torch.float32, device=key.device)

        def fan(k, shape, n):
            return prng.normal(k, shape, dt) / _as(float(np.sqrt(_NP[dt](n))),
                                                   key, dt)

        return {"w1": fan(k1, (c, h), c), "b1": zeros(h),
                "w2": fan(k2, (h, h), h), "b2": zeros(h),
                "w3": fan(k3, (h, 1), h), "b3": zeros(1)}

    def predict(self, params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        return _forward(params, x)

    def fit(self, params: Dict[str, torch.Tensor], x: torch.Tensor,
            target: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Fixed-budget full-batch Adam, warm-started (approximate
        projection); the inputs are not modified."""
        names = sorted(params)
        p = {k: params[k].detach().clone() for k in names}
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v = {k: torch.zeros_like(t) for k, t in p.items()}
        run_dt = _NP[x.dtype]
        with torch.enable_grad():
            for t in range(1, self.fit_steps + 1):
                leaves = [p[k].requires_grad_(True) for k in names]
                loss = torch.mean((_forward(p, x) - target) ** 2, dim=-1)
                grads = torch.autograd.grad(loss.sum(), leaves)
                # the bias corrections in the run's dtype, then each leaf's
                bc1 = float(run_dt(1.0) - run_dt(0.9) ** run_dt(t))
                bc2 = float(run_dt(1.0) - run_dt(0.999) ** run_dt(t))
                with torch.no_grad():
                    for k, g in zip(names, grads):
                        # XLA's CPU code fuses the decay into one
                        # multiply-add: the moments' bits are the JAX package's
                        m[k] = prng._fma(m[k], 0.9, 0.1 * g)
                        v[k] = prng._fma(v[k], 0.999, 0.001 * (g * g))
                        lr_m = self.lr * (m[k] / _as(bc1, m[k]))
                        p[k] = p[k].detach() - lr_m / (
                            libm.sqrt(v[k] / _as(bc2, v[k])) + 1e-8)
        return {k: t.detach() for k, t in p.items()}


def _as(value: float, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """A host float as a 0-d tensor of `like`'s dtype (or `dtype`) on its
    device, a divisor: PyTorch's CUDA code divides by a Python number as a
    product with its rounded reciprocal (an ulp off the quotient), by a
    device tensor exactly, as XLA's CPU code and the CPU here do."""
    return torch.full((), value, dtype=dtype or like.dtype, device=like.device)
