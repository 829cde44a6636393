"""Degree-d polynomial ridge regression agents (the paper's Table 2 family).

Twin of repro.agents.polynomial.  The ICOA projection "train f_i with f_hat_i
as the outcome" is an exact closed-form ridge solve.  Features for agent
columns x (N, C): the powers x_c^k, k = 1..degree, the pairwise products
x_a * x_b for C > 1, and a bias — [1, x, .., x^d] for the paper's C = 1.

Params of D agents stack along a leading axis, so `fit`/`predict` also take
(D, N, C) columns with (D, N) targets and (D, P) params: the explicit batch
axis stands in for the JAX package's vmap over agents.  Any further leading
axes batch the same way, e.g. (B, D, N, C) for B Monte-Carlo trials.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["PolynomialFamily"]


def _features(x: torch.Tensor, degree: int) -> torch.Tensor:
    """(..., N, C) -> (..., N, P) polynomial feature map."""
    c = x.shape[-1]
    feats = [torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)]
    for k in range(1, degree + 1):
        feats.append(x ** k)
    for a in range(c):
        for b in range(a + 1, c):
            feats.append((x[..., a] * x[..., b])[..., None])
    return torch.cat(feats, dim=-1)


@dataclasses.dataclass(frozen=True)
class PolynomialFamily:
    n_cols: int
    degree: int = 4
    ridge: float = 1e-6

    @property
    def n_features(self) -> int:
        return 1 + self.n_cols * self.degree + self.n_cols * (self.n_cols - 1) // 2

    def init(self, key: torch.Tensor, dtype=None) -> torch.Tensor:
        """Zero params (..., P) in float32 for keys (..., 2), as the JAX
        package's (the key and the run's dtype are not read) — the first
        `fit` overwrites them."""
        del dtype
        return torch.zeros((*key.shape[:-1], self.n_features),
                           dtype=torch.float32, device=key.device)

    def fit(self, params: torch.Tensor, x: torch.Tensor,
            target: torch.Tensor) -> torch.Tensor:
        """Closed-form ridge solve: the projection of `target` onto H_i."""
        del params  # closed form — no warm start needed
        phi = _features(x, self.degree)
        p = phi.shape[-1]
        eye = torch.eye(p, dtype=phi.dtype, device=phi.device)
        phi_t = phi.transpose(-1, -2)
        gram = phi_t @ phi + self.ridge * eye
        rhs = (phi_t @ target[..., None])[..., 0]
        # solve_ex: no singularity check, so no host sync inside the agent
        # loop (a singular system gives non-finite params, as in JAX)
        return torch.linalg.solve_ex(gram, rhs)[0]

    def predict(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return (_features(x, self.degree) @ params[..., None])[..., 0]
