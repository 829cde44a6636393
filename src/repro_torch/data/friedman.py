"""Friedman-1/2/3 synthetic regression data, as used in the paper (Sec 3.2).

Twin of repro.data.friedman.  Draws come from a `torch.Generator`, so the
numbers differ from jax.random's threefry streams for the same seed until
ROADMAP A7 (a bit-exact threefry port) lands: the distributions and the
formulas are the same, the samples are not.  Tests that compare the two
packages hand both the same numpy arrays instead.
"""
from __future__ import annotations

import math

import torch

__all__ = ["friedman1", "friedman2", "friedman3", "standardise"]


def _normalise(y: torch.Tensor) -> torch.Tensor:
    lo, hi = torch.min(y), torch.max(y)
    return (y - lo) / torch.clamp(hi - lo, min=1e-12)


def _uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0):
    return lo + (hi - lo) * torch.rand(shape, generator=gen)


def _normal(gen: torch.Generator, shape):
    return torch.randn(shape, generator=gen)


def friedman1(gen: torch.Generator, n: int, noise: float = 0.0):
    """phi(x) = 10 sin(pi x1 x2) + 20 (x3 - 1/2)^2 + 10 x4 + 5 x5,  x_j ~ U[0,1]."""
    x = _uniform(gen, (n, 5))
    y = (10.0 * torch.sin(math.pi * x[:, 0] * x[:, 1])
         + 20.0 * (x[:, 2] - 0.5) ** 2
         + 10.0 * x[:, 3]
         + 5.0 * x[:, 4])
    y = y + noise * _normal(gen, (n,))
    return x, _normalise(y)


def _friedman23_covariates(gen: torch.Generator, n: int) -> torch.Tensor:
    x1 = _uniform(gen, (n,), 1.0, 100.0)
    x2 = _uniform(gen, (n,), 40.0 * math.pi, 560.0 * math.pi)
    x3 = _uniform(gen, (n,))
    x4 = _uniform(gen, (n,), 1.0, 11.0)
    x5 = _uniform(gen, (n,))  # nuisance attribute
    return torch.stack([x1, x2, x3, x4, x5], dim=1)


def friedman2(gen: torch.Generator, n: int, noise: float = 0.0):
    """phi(x) = sqrt(x1^2 + (x2 x3 - 1/(x2 x4))^2); X5 is a nuisance variable."""
    x = _friedman23_covariates(gen, n)
    y = torch.sqrt(x[:, 0] ** 2
                   + (x[:, 1] * x[:, 2] - 1.0 / (x[:, 1] * x[:, 3])) ** 2)
    y = y + noise * _normal(gen, (n,))
    return x, _normalise(y)


def friedman3(gen: torch.Generator, n: int, noise: float = 0.0):
    """phi(x) = atan((x2 x3 - 1/(x2 x4)) / x1); X5 is a nuisance variable."""
    x = _friedman23_covariates(gen, n)
    y = torch.atan((x[:, 1] * x[:, 2] - 1.0 / (x[:, 1] * x[:, 3])) / x[:, 0])
    y = y + noise * _normal(gen, (n,))
    return x, _normalise(y)


def standardise(xtr: torch.Tensor, xte: torch.Tensor):
    """Standardise both splits with the train split's mean and (population)
    standard deviation, as the JAX package does."""
    mu = xtr.mean(dim=0)
    sd = xtr.std(dim=0, correction=0) + 1e-12
    return (xtr - mu) / sd, (xte - mu) / sd

