"""Friedman-1/2/3 synthetic regression data, as used in the paper (Sec 3.2).

Twin of repro.data.friedman, drawn from the same threefry stream
(repro_torch.prng): the same seed gives the JAX package's covariates bit for
bit (float32, or float64 as under jax_enable_x64).  Friedman-1's and
Friedman-3's float32 outcomes are its bits too (the C library's sinf and
atanf, data.libm); float64 outcomes are within the ulp bounds of its
normals, and Friedman-2's of its sqrt and the multiply-adds XLA fuses.

A key (..., 2) draws one dataset per key: x (..., n, 5), y (..., n), so a
(B, 2) key stack draws B Monte-Carlo trials in one pass, on the key's
device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import prng
from repro_torch.data import libm

__all__ = ["friedman1", "friedman2", "friedman3", "make_dataset",
           "standardise", "xla_sum", "FRIEDMAN_FNS"]


def _normalise(y: torch.Tensor) -> torch.Tensor:
    """Outcomes mapped onto [0, 1] per dataset (over the last axis)."""
    lo = torch.amin(y, dim=-1, keepdim=True)
    hi = torch.amax(y, dim=-1, keepdim=True)
    return (y - lo) / torch.clamp(hi - lo, min=1e-12)


def friedman1(key: torch.Tensor, n: int, noise: float = 0.0,
              dtype: torch.dtype = torch.float32):
    """phi(x) = 10 sin(pi x1 x2) + 20 (x3 - 1/2)^2 + 10 x4 + 5 x5,  x_j ~ U[0,1]."""
    kx, kw = prng.split(key).unbind(-2)
    x = prng.uniform(kx, (n, 5), dtype)
    y = (10.0 * libm.sin(math.pi * x[..., 0] * x[..., 1])
         + 20.0 * (x[..., 2] - 0.5) ** 2
         + 10.0 * x[..., 3]
         + 5.0 * x[..., 4])
    y = y + noise * prng.normal(kw, (n,), dtype)
    return x, _normalise(y)


def _friedman23_covariates(key: torch.Tensor, n: int,
                           dtype: torch.dtype) -> torch.Tensor:
    ks = prng.split(key, 5).unbind(-2)
    x1 = prng.uniform(ks[0], (n,), dtype, 1.0, 100.0)
    x2 = prng.uniform(ks[1], (n,), dtype, 40.0 * math.pi, 560.0 * math.pi)
    x3 = prng.uniform(ks[2], (n,), dtype)
    x4 = prng.uniform(ks[3], (n,), dtype, 1.0, 11.0)
    x5 = prng.uniform(ks[4], (n,), dtype)  # nuisance attribute
    return torch.stack([x1, x2, x3, x4, x5], dim=-1)


def friedman2(key: torch.Tensor, n: int, noise: float = 0.0,
              dtype: torch.dtype = torch.float32):
    """phi(x) = sqrt(x1^2 + (x2 x3 - 1/(x2 x4))^2); X5 is a nuisance variable."""
    kx, kw = prng.split(key).unbind(-2)
    x = _friedman23_covariates(kx, n, dtype)
    y = torch.sqrt(x[..., 0] ** 2
                   + (x[..., 1] * x[..., 2] - 1.0 / (x[..., 1] * x[..., 3])) ** 2)
    y = y + noise * prng.normal(kw, (n,), dtype)
    return x, _normalise(y)


def friedman3(key: torch.Tensor, n: int, noise: float = 0.0,
              dtype: torch.dtype = torch.float32):
    """phi(x) = atan((x2 x3 - 1/(x2 x4)) / x1); X5 is a nuisance variable."""
    kx, kw = prng.split(key).unbind(-2)
    x = _friedman23_covariates(kx, n, dtype)
    y = libm.atan((x[..., 1] * x[..., 2] - 1.0 / (x[..., 1] * x[..., 3]))
                  / x[..., 0])
    y = y + noise * prng.normal(kw, (n,), dtype)
    return x, _normalise(y)


FRIEDMAN_FNS = {1: friedman1, 2: friedman2, 3: friedman3}


def xla_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over `dim` in the order of XLA's CPU code for a reduction
    over a major axis: up to 32 values are added one by one from 0; a
    longer axis is padded with zeros to a multiple of 32 (half the padding,
    rounded down, in front), each window of 32 is added one by one, and the
    window sums are reduced the same way.  Plain adds only, so every device
    gives the same bits."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    if n > 32:
        padded = -(-n // 32) * 32
        lo = (padded - n) // 2
        z = x.new_zeros((padded, *x.shape[1:]))
        z[lo:lo + n] = x
        x = z.reshape(padded // 32, 32, *x.shape[1:]).movedim(1, 0)
    acc = torch.zeros_like(x[0])
    for k in range(x.shape[0]):
        acc = acc + x[k]
    return acc if n <= 32 else xla_sum(acc, 0)


def standardise(xtr: torch.Tensor, xte: torch.Tensor):
    """Standardise both splits with the train split's mean and (population)
    standard deviation over its instances (axis -2), with the JAX
    package's operations in XLA's order: the sums by `xla_sum`, the mean
    as the sum times the rounded reciprocal of N (XLA's rewrite of a
    division by a constant), the variance as a true division by N."""
    n = xtr.shape[-2]
    mu = (xla_sum(xtr, -2)
          * (torch.ones((), dtype=xtr.dtype, device="cpu") / n).to(xtr.device)).unsqueeze(-2)
    cen = xtr - mu
    var = xla_sum(cen * cen, -2) / torch.full((), float(n), dtype=xtr.dtype,
                                              device=xtr.device)
    sd = libm.sqrt(var).unsqueeze(-2) + 1e-12
    return (xtr - mu) / sd, (xte - mu) / sd


def make_dataset(which: int, n_train: int = 4000, n_test: int = 4000,
                 seed: int = 0, noise: float = 0.0,
                 dtype: Optional[torch.dtype] = None, device="cpu"):
    """Train/test split with standardised covariates (fit on train), drawn
    on `device` in `dtype` (None: torch's default float dtype):
    split(PRNGKey(seed)) gives the train and test streams."""
    if dtype is None:
        dtype = torch.get_default_dtype()
    fn = FRIEDMAN_FNS[which]
    k1, k2 = prng.split(prng.PRNGKey(seed, device=device)).unbind(-2)
    xtr, ytr = fn(k1, n_train, noise, dtype)
    xte, yte = fn(k2, n_test, noise, dtype)
    xtr, xte = standardise(xtr, xte)
    return xtr, ytr, xte, yte
