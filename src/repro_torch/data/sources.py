"""Data-source registry: every scenario generator behind one contract.

Twin of repro.data.sources.  A source maps
`(key, n, n_attrs, noise, dtype, **options) -> (x, y)`, x (..., n, n_attrs),
y (..., n) normalised to [0, 1], from a threefry key (..., 2) of
repro_torch.prng: the JAX package's stream, so a seed gives its data (the
uniforms bit for bit, the normals within prng's ulp bounds).  `dtype` is
the draw's float type: float64 draws 64-bit words, as jax does under
jax_enable_x64.  A key stack (B, 2) draws B datasets in one pass on the
key's device; the steps whose summation order depends on the shape (the
products and the standardisation's sums) run trial by trial (`per_trial`),
so trial b has the bits of a single draw of its seed on that device.
Registered: the paper's three Friedman problems, the correlated-design
linear model and the additive cosine model.
"""
from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch import prng
from repro_torch.data import friedman, libm

__all__ = ["Source", "SOURCES", "register_source", "make_dataset",
           "make_trial_batch", "partition_columns", "correlated_linear",
           "cosine_additive", "per_trial"]


@dataclasses.dataclass(frozen=True)
class Source:
    """Registry entry: the generator plus its attribute-count contract."""

    name: str
    fn: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    n_attrs: Optional[int]      # fixed attribute count (None = caller's choice)
    default_n_attrs: int        # used when DataSpec.n_attrs is None
    options: Tuple[str, ...]    # recognised **option names

    def resolve_n_attrs(self, n_attrs: Optional[int]) -> int:
        if self.n_attrs is not None:
            if n_attrs not in (None, self.n_attrs):
                raise ValueError(
                    f"source {self.name!r} has a fixed attribute count of "
                    f"{self.n_attrs}, got n_attrs={n_attrs}")
            return self.n_attrs
        m = self.default_n_attrs if n_attrs is None else n_attrs
        if m < 1:
            raise ValueError(f"need n_attrs >= 1, got {m}")
        return m


SOURCES: Dict[str, Source] = {}


def register_source(name: str, *, n_attrs: Optional[int] = None,
                    default_n_attrs: Optional[int] = None):
    """Register a `(key, n, n_attrs, noise, dtype, **options) -> (x, y)`
    generator; keyword parameters after the five positional ones become the
    source's recognised options."""

    def deco(fn):
        params = list(inspect.signature(fn).parameters)[5:]
        SOURCES[name] = Source(
            name=name, fn=fn, n_attrs=n_attrs,
            default_n_attrs=n_attrs if n_attrs is not None
            else (5 if default_n_attrs is None else default_n_attrs),
            options=tuple(params))
        return fn

    return deco


def per_trial(fn, batch_dims: int, *xs):
    """fn applied to each trial's slices of xs (whose first `batch_dims`
    axes are trials), the results stacked back: every call sees a single
    trial's shapes, so its bits do not depend on the batch.  fn returns a
    tensor or a tuple of them."""
    if batch_dims == 0:
        return fn(*xs)
    lead = xs[0].shape[:batch_dims]
    flat = [x.reshape(-1, *x.shape[batch_dims:]) for x in xs]
    outs = [fn(*(x[b] for x in flat)) for b in range(flat[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o).reshape(*lead, *o[0].shape)
                     for o in zip(*outs))
    return torch.stack(outs).reshape(*lead, *outs[0].shape)


@register_source("friedman1", n_attrs=5)
def _friedman1(key, n: int, n_attrs: int, noise: float, dtype):
    return friedman.friedman1(key, n, noise, dtype)


@register_source("friedman2", n_attrs=5)
def _friedman2(key, n: int, n_attrs: int, noise: float, dtype):
    return friedman.friedman2(key, n, noise, dtype)


@register_source("friedman3", n_attrs=5)
def _friedman3(key, n: int, n_attrs: int, noise: float, dtype):
    return friedman.friedman3(key, n, noise, dtype)


@register_source("correlated_linear", default_n_attrs=8)
def correlated_linear(key, n: int, n_attrs: int, noise: float, dtype,
                      rho: float = 0.6, snr: float = 10.0):
    """Correlated-design linear model (Hellkvist et al. 2021 setting):
    x ~ N(0, Sigma) with Sigma_ij = rho^|i-j|, y = x @ w with w ~ N(0, I/M),
    plus Gaussian noise sized for signal-to-noise ratio `snr` and the
    DataSpec-level `noise` on top."""
    kx, kw, ke, kd = prng.split(key, 4).unbind(-2)
    j = torch.arange(n_attrs, dtype=dtype, device=key.device)
    sigma = rho ** torch.abs(j[:, None] - j[None, :])
    chol = torch.linalg.cholesky(
        sigma + 1e-9 * torch.eye(n_attrs, dtype=dtype, device=key.device))
    w = prng.normal(kw, (n_attrs,), dtype) / math.sqrt(float(n_attrs))

    def mix(z, w):
        x = z @ chol.T
        return x, x @ w, w @ sigma @ w

    x, y, sig2 = per_trial(mix, key.dim() - 1,
                           prng.normal(kx, (n, n_attrs), dtype), w)
    y = y + torch.sqrt(sig2 / snr)[..., None] * prng.normal(ke, (n,), dtype)
    y = y + noise * prng.normal(kd, (n,), dtype)
    return x, friedman._normalise(y)


@register_source("cosine", default_n_attrs=5)
def cosine_additive(key, n: int, n_attrs: int, noise: float, dtype,
                    freq: float = 1.0):
    """Dimensionally-distributed additive cosine model (Zheng & Kulkarni
    '08): y = sum_j cos(2 pi freq (j+1) x_j) / (j + 1), x_j ~ U[0, 1]."""
    kx, kw = prng.split(key).unbind(-2)
    x = prng.uniform(kx, (n, n_attrs), dtype)
    j = torch.arange(n_attrs, dtype=dtype, device=key.device)
    comps = libm.cos(2.0 * math.pi * freq * (j + 1.0) * x) / (j + 1.0)
    y = friedman.xla_sum(comps, -1)          # XLA's order: the JAX package's bits
    y = y + noise * prng.normal(kw, (n,), dtype)
    return x, friedman._normalise(y)


def make_dataset(source: str, n_train: int, n_test: int, seed,
                 noise: float = 0.0, n_attrs: Optional[int] = None,
                 options: Sequence[Tuple[str, Any]] = (),
                 dtype: Optional[torch.dtype] = None, device="cpu"):
    """Train/test split from a registered source, standardised on train
    stats, drawn on `device` in `dtype` (None: torch's default float dtype,
    as the JAX package draws in jax's): split(PRNGKey(seed)) gives the
    train and the test stream, as in the JAX package.  A sequence of seeds
    draws one dataset per seed along a leading trial axis, in one pass."""
    if dtype is None:
        dtype = torch.get_default_dtype()
    src = SOURCES.get(source)
    if src is None:
        raise ValueError(f"unknown data source {source!r}; "
                         f"registered: {sorted(SOURCES)}")
    m = src.resolve_n_attrs(n_attrs)
    kw = dict(options)
    keys = prng.split(prng.PRNGKey(seed, device=device))
    xtr, ytr = src.fn(keys[..., 0, :], n_train, m, noise, dtype, **kw)
    xte, yte = src.fn(keys[..., 1, :], n_test, m, noise, dtype, **kw)
    xtr, xte = per_trial(friedman.standardise, keys.dim() - 2, xtr, xte)
    return xtr, ytr, xte, yte


def partition_columns(x: torch.Tensor, groups: Sequence[Sequence[int]]
                      ) -> torch.Tensor:
    """(..., N, M) covariates -> (..., D, N, C) agent column views."""
    idx = torch.tensor(groups, dtype=torch.int64, device=x.device)
    return x[..., idx].movedim(-2, -3).contiguous()


def make_trial_batch(source: str, n_train: int, n_test: int,
                     seeds: Sequence[int], groups: Sequence[Sequence[int]],
                     noise: float = 0.0, n_attrs: Optional[int] = None,
                     options: Sequence[Tuple[str, Any]] = (),
                     dtype: Optional[torch.dtype] = None, device="cpu"):
    """The Monte-Carlo batch of datasets, one per seed, drawn in one pass
    from the (B, 2) key stack on `device`, partitioned and stacked along a
    leading trial axis: (xcols (B, D, N, C), y (B, N), xcols_test
    (B, D, N_test, C), y_test (B, N_test)) in `dtype` (None: torch's
    default float dtype).  Trial b is exactly
    `make_dataset(..., seed=seeds[b])` on that device, partitioned by
    `groups`."""
    xtr, ytr, xte, yte = make_dataset(source, n_train, n_test, list(seeds),
                                      noise=noise, n_attrs=n_attrs,
                                      options=options, dtype=dtype,
                                      device=device)
    return (partition_columns(xtr, groups), ytr,
            partition_columns(xte, groups), yte)
