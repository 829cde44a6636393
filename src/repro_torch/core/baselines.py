"""The paper's two comparison algorithms (Table 1): averaging and residual
refitting (twin of repro.core.baselines).

Averaging: every agent fits y once, non-cooperatively; the ensemble is the
uniform mean (no residual traffic).

Residual refitting (ICEA): the residual is passed around the ring; agent i
refits whatever residual agents 1..i-1 left, greedily driving the training
error to zero — which is why it overtrains (paper Fig. 1).

Both take an optional leading Monte-Carlo trial axis — xcols (B, D, N, C),
y (B, N) — in place of the JAX package's `averaging_scan` /
`residual_refitting_scan` under vmap: the same math on every trial at once,
the records then (B,) tensors.  The refit ring's payload — the
leave-me-out ensemble sum each updater receives — passes the transport's
codec once (`_loo_residual`); an identity codec keeps the plain expression.
Every agent starts from `family.init` of its key in split(PRNGKey(seed), D)
(per trial for a sequence of seeds), as in the JAX package: the mlp
family warm-starts from those weights.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.analysis import sanitize
from repro_torch.core import covariance as cov
from repro_torch.core import ensemble
from repro_torch.core.icoa import init_keys
from repro_torch.core.tree import store, take, tree_map

__all__ = ["averaging", "residual_refitting", "align_param_dtypes"]


def _loo_residual(codec, y: torch.Tensor, f_sum: torch.Tensor,
                  f_i: torch.Tensor) -> torch.Tensor:
    """Agent i's refit target from what it receives: the leave-me-out
    ensemble sum through the codec, coded once.  No codec, or one that is
    the identity for the dtype, keeps y - f_sum + f_i bit for bit (the
    algebraically equal regrouping differs by ulps)."""
    if codec is None or codec.is_identity_for(f_sum.dtype):
        return y - f_sum + f_i
    return y - sanitize.check_finite(
        codec.roundtrip(f_sum - f_i),
        f"baselines leave-one-out refit: codec {codec.name!r} delivered a "
        f"non-finite ensemble sum")


def align_param_dtypes(params, like):
    """Stacked init params cast to the dtypes `family.fit` returns (those
    of `like`, one agent's fitted params): the refit ring carries
    never-fitted params beside fitted ones, and the closed-form families'
    float32 zero init becomes the data's dtype on its first fit."""
    return tree_map(lambda t, v: t.to(v.dtype), params, like)


def _init(family, xcols: torch.Tensor, seed):
    """Every agent's init params, from split(PRNGKey(seed), D) (a seed per
    trial for a batch)."""
    keys = init_keys(seed, xcols.shape[-3], xcols.device)
    return family.init(keys.expand(*xcols.shape[:-1][:-1], 2), xcols.dtype)


def _fit_all(family, xcols: torch.Tensor, y: torch.Tensor, seed):
    """Every agent fits y directly from its init: params (..., D, ...),
    f (..., D, N)."""
    d, n = xcols.shape[-3], xcols.shape[-2]
    params = family.fit(_init(family, xcols, seed), xcols,
                        y[..., None, :].expand(*y.shape[:-1], d, n))
    return params, family.predict(params, xcols)


def _eta(f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The MSE an optimal re-weighting of the agents would reach (a
    diagnostic beside ICOA's records), per trial."""
    return ensemble.eta(cov.gram(y[..., None, :] - f))


def averaging(family, xcols: torch.Tensor, y: torch.Tensor,
              xcols_test: Optional[torch.Tensor] = None,
              y_test: Optional[torch.Tensor] = None, seed=0):
    """Non-cooperative uniform ensemble.  Returns (params, f, hist): hist
    holds one record of train_mse and eta, and of test_mse when test data
    is given — floats for one trial, (B,) tensors for a batch (`seed` then
    one per trial)."""
    params, f = _fit_all(family, xcols, y, seed)
    batched = y.dim() == 2

    def out(t):
        return t if batched else float(t)

    hist = {"train_mse": out(torch.mean((y - f.mean(dim=-2)) ** 2, dim=-1)),
            "eta": out(_eta(f, y))}
    if xcols_test is not None:
        ft = family.predict(params, xcols_test)
        hist["test_mse"] = out(torch.mean((y_test - ft.mean(dim=-2)) ** 2,
                                          dim=-1))
    return params, f, hist


def residual_refitting(family, xcols: torch.Tensor, y: torch.Tensor,
                       xcols_test: Optional[torch.Tensor] = None,
                       y_test: Optional[torch.Tensor] = None,
                       n_cycles: int = 30, seed=0, codec=None):
    """ICEA ring: the ensemble prediction is the SUM of the agents; each
    agent in turn refits y minus the others' sum, received through `codec`
    (transport.Codec; None: as sent).  Returns (params, f, hist)
    with one record per cycle of train_mse, eta and (with test data)
    test_mse: lists of floats for one trial, (B, n_cycles) tensors for a
    batch (`seed` then one per trial).  Nothing in the loop waits for the
    device."""
    d, n = xcols.shape[-3], xcols.shape[-2]
    lead = y.shape[:-1]
    params = _init(family, xcols, seed)
    aligned = False
    f = torch.zeros((*lead, d, n), dtype=y.dtype, device=y.device)
    recs = {"train_mse": [], "test_mse": [], "eta": []}
    for _ in range(n_cycles):
        for i in range(d):
            # the leave-agent-i-out sum is what crosses the wire to agent i
            residual = _loo_residual(codec, y, f.sum(dim=-2), f[..., i, :])
            p_i = family.fit(take(params, i, len(lead)), xcols[..., i, :, :],
                             residual)
            if not aligned:
                params, aligned = align_param_dtypes(params, p_i), True
            store(params, i, len(lead), p_i)
            f[..., i, :] = family.predict(p_i, xcols[..., i, :, :])
        recs["train_mse"].append(torch.mean((y - f.sum(dim=-2)) ** 2, dim=-1))
        if xcols_test is not None:
            ft = family.predict(params, xcols_test)
            recs["test_mse"].append(torch.mean((y_test - ft.sum(dim=-2)) ** 2,
                                               dim=-1))
        recs["eta"].append(_eta(f, y))
    if len(lead):
        hist = {k: torch.stack(v, dim=-1) for k, v in recs.items() if v}
    else:
        hist = {k: [float(t) for t in v] for k, v in recs.items() if v}
    return params, f, hist
