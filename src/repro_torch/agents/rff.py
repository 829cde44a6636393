"""Random-Fourier-feature (RBF kernel) ridge agents (twin of
repro.agents.rff).

f_i(x) = phi(x)^T beta with phi(x) = sqrt(2/F) cos(x Omega + b),
Omega ~ N(0, 1/lengthscale^2): an explicit-feature approximation of
Gaussian-kernel ridge regression.  The projection is a closed-form ridge
solve, as in the polynomial family, over a far richer space.  The feature
directions are part of the frozen family: drawn from `PRNGKey(seed)` by
the JAX package's key stream (repro_torch.prng), so Omega and the phases
are its bits, and the float32 features too (the C library's cosf,
data.libm) where a feature is one product per column (the paper's one
column an agent).

Params of D agents stack along a leading axis, and further leading axes
batch the same way: x (..., N, C), target (..., N), params (..., F).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.data import libm

__all__ = ["RFFFamily"]

_NP = {torch.float32: np.float32, torch.float64: np.float64}


@dataclasses.dataclass(frozen=True)
class RFFFamily:
    n_cols: int
    n_features: int = 64
    lengthscale: float = 0.5
    ridge: float = 1e-4
    seed: int = 0  # feature directions are part of the (frozen) family

    def _omega(self, dtype: torch.dtype, device="cpu"):
        """(Omega (C, F), phase (F,)) in `dtype`: the JAX package's draws
        from split(PRNGKey(seed)) in its default float dtype."""
        k1, k2 = prng.split(prng.PRNGKey(self.seed, device=device)).unbind(-2)
        # a device divisor: a true quotient on the card too (not a product
        # with the rounded reciprocal, as a Python number would give)
        ls = torch.full((), self.lengthscale, dtype=dtype, device=device)
        omega = prng.normal(k1, (self.n_cols, self.n_features), dtype) / ls
        phase = prng.uniform(k2, (self.n_features,), dtype) * 2.0 * np.pi
        return omega, phase

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        omega, phase = self._omega(x.dtype, x.device)
        scale = float(np.sqrt(_NP[x.dtype](2.0 / self.n_features)))
        return scale * libm.cos(x @ omega + phase)

    def init(self, key: torch.Tensor, dtype=None) -> torch.Tensor:
        """Zero coefficients (..., F) in float32 for keys (..., 2), as the
        JAX package's; the first `fit` overwrites them."""
        del dtype
        return torch.zeros((*key.shape[:-1], self.n_features),
                           dtype=torch.float32, device=key.device)

    def fit(self, params, x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Closed-form ridge solve on the features: the projection of
        `target`."""
        del params
        phi = self._features(x)
        phi_t = phi.transpose(-1, -2)
        eye = torch.eye(self.n_features, dtype=phi.dtype, device=phi.device)
        gram = phi_t @ phi + self.ridge * eye
        rhs = (phi_t @ target[..., None])[..., 0]
        # solve_ex: no singularity check, so no host sync inside the agent loop
        return torch.linalg.solve_ex(gram, rhs)[0]

    def predict(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return (self._features(x) @ params[..., None].to(x.dtype))[..., 0]
