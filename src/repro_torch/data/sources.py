"""Data-source registry: every scenario generator behind one contract.

Twin of repro.data.sources for this slice.  A source maps
`(gen, n, n_attrs, noise, **options) -> (x, y)`, x (n, n_attrs), y (n,)
normalised to [0, 1]; `gen` is a `torch.Generator` (see data.friedman on
why its samples differ from the JAX package's).  Registered: the paper's
three Friedman problems and the correlated-design linear model; the
additive cosine model waits for ROADMAP A7.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.data import friedman

__all__ = ["Source", "SOURCES", "NOT_PORTED", "register_source",
           "make_dataset", "make_trial_batch", "correlated_linear"]

# sources of the JAX package that are not ported yet -> the ROADMAP item
NOT_PORTED = {"cosine": "A7"}


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
    """Register a `(gen, n, n_attrs, noise, **options) -> (x, y)` generator."""

    def deco(fn):
        params = list(inspect.signature(fn).parameters)[4:]
        SOURCES[name] = Source(
            name=name, fn=fn, n_attrs=n_attrs,
            default_n_attrs=n_attrs if n_attrs is not None
            else (5 if default_n_attrs is None else default_n_attrs),
            options=tuple(params))
        return fn

    return deco


@register_source("friedman1", n_attrs=5)
def _friedman1(gen, n: int, n_attrs: int, noise: float):
    return friedman.friedman1(gen, n, noise)


@register_source("friedman2", n_attrs=5)
def _friedman2(gen, n: int, n_attrs: int, noise: float):
    return friedman.friedman2(gen, n, noise)


@register_source("friedman3", n_attrs=5)
def _friedman3(gen, n: int, n_attrs: int, noise: float):
    return friedman.friedman3(gen, n, noise)


@register_source("correlated_linear", default_n_attrs=8)
def correlated_linear(gen, n: int, n_attrs: int, noise: float,
                      rho: float = 0.6, snr: float = 10.0):
    """Correlated-design linear model (Hellkvist et al. 2021 setting):
    x ~ N(0, Sigma) with Sigma_ij = rho^|i-j|, y = x @ w with w ~ N(0, I/M),
    plus Gaussian noise sized for signal-to-noise ratio `snr` and the
    DataSpec-level `noise` on top."""
    dt = torch.get_default_dtype()
    j = torch.arange(n_attrs, dtype=dt)
    sigma = rho ** torch.abs(j[:, None] - j[None, :])
    chol = torch.linalg.cholesky(sigma + 1e-9 * torch.eye(n_attrs, dtype=dt))
    x = friedman._normal(gen, (n, n_attrs)) @ chol.T
    w = friedman._normal(gen, (n_attrs,)) / float(n_attrs) ** 0.5
    y = x @ w
    sig2 = w @ sigma @ w
    y = y + torch.sqrt(sig2 / snr) * friedman._normal(gen, (n,))
    y = y + noise * friedman._normal(gen, (n,))
    return x, friedman._normalise(y)


def make_dataset(source: str, n_train: int, n_test: int, seed: int,
                 noise: float = 0.0, n_attrs: Optional[int] = None,
                 options: Sequence[Tuple[str, Any]] = ()):
    """Train/test split from a registered source, standardised on train
    stats.  One CPU generator seeded by `seed` draws the train split, then
    the test split, so a seed gives the same data on every device."""
    src = SOURCES.get(source)
    if src is None:
        raise ValueError(f"unknown data source {source!r}; "
                         f"registered: {sorted(SOURCES)}")
    m = src.resolve_n_attrs(n_attrs)
    kw = dict(options)
    gen = torch.Generator().manual_seed(seed)
    xtr, ytr = src.fn(gen, n_train, m, noise, **kw)
    xte, yte = src.fn(gen, n_test, m, noise, **kw)
    xtr, xte = friedman.standardise(xtr, xte)
    return xtr, ytr, xte, yte


def make_trial_batch(source: str, n_train: int, n_test: int,
                     seeds: Sequence[int], groups: Sequence[Sequence[int]],
                     noise: float = 0.0, n_attrs: Optional[int] = None,
                     options: Sequence[Tuple[str, Any]] = (),
                     dtype: Optional[torch.dtype] = None, device="cpu"):
    """The Monte-Carlo batch of datasets, one per seed, partitioned and
    stacked along a leading trial axis: (xcols (B, D, N, C), y (B, N),
    xcols_test (B, D, N_test, C), y_test (B, N_test)) on `device`, cast to
    `dtype` when given (BackendSpec.compute_dtype).  Trial b is exactly
    `make_dataset(..., seed=seeds[b])` partitioned by `groups`."""
    parts: List[List[torch.Tensor]] = [[], [], [], []]
    for seed in seeds:
        xtr, ytr, xte, yte = make_dataset(source, n_train, n_test, seed,
                                          noise=noise, n_attrs=n_attrs,
                                          options=options)
        for out, a in zip(parts, (torch.stack([xtr[:, g] for g in groups]),
                                  ytr, torch.stack([xte[:, g] for g in groups]),
                                  yte)):
            out.append(a)
    stacked = []
    for out in parts:
        a = torch.stack(out)
        stacked.append(a.to(device=device, dtype=dtype or a.dtype))
    return tuple(stacked)
