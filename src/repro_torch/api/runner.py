"""Compiled Monte Carlo: many trials of one spec as one batched program
(twin of repro.api.runner for the local backend).

Every figure of the paper averages over independent trials of one scenario.
`fit` runs one trial; `batch_fit` runs `n_trials` of them at once: the
trials' datasets are stacked along a leading trial axis and the whole batch
goes through `core.icoa.run_scan`, where every tensor of the solve carries
that axis and, with `use_kernel`, every product is one launch of a batched
kernel for all trials — the explicit counterpart of the JAX package's
`jit(vmap(run_fn))`.

The paper's two baselines batch the same way (core.baselines with a
leading trial axis).  Trial t of a spec is `fit(trial_spec(spec, t))`: the
data seed and the solver seed are both offset by t, so trial t draws its
subsamples from PRNGKey(spec.seed + t + 1), as in the JAX package.  The one
difference, as in the JAX package: the batched schedule is static, so
`solver.eps` stops nothing and `History.converged_at` records where fit's
eps rule would have stopped.  The trials' data are drawn on the device in
one pass from the stack of their keys (data.sources.make_trial_batch).

On the shard_map backend only the serial form runs (`compiled=False`:
every trial one `fit`, one agent a rank); the compiled trial loop waits
for ROADMAP A11b.

BackendSpec's Monte-Carlo knobs: `trial_devices` of None or 1 runs on one
card (more waits for ROADMAP A11b); `compute_dtype` casts the generated data,
and so the whole solve (the draw is in torch's default float dtype, as
`fit`'s); `donate` is accepted and has no effect (PyTorch runs
eagerly: there is no compiled program whose input buffer could be donated).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.analysis import sanitize
from repro_torch.api.result import History, Result, ResultSet
from repro_torch.api.solvers import bytes_history
from repro_torch.api.specs import ExperimentSpec, SpecError, _not_ported
from repro_torch.core import baselines, icoa
from repro_torch.core.tree import tree_map
from repro_torch.data import sources as data_sources
from repro_torch.obs import taps as obs_taps

__all__ = ["batch_fit", "trial_spec", "resolve_device"]

_COMPILED_SOLVERS = ("icoa", "averaging", "residual_refitting")


def resolve_device(device, entry: str = "repro_torch.api") -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    asks for the CPU; without a CUDA device, "cuda" raises rather than
    carrying on elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{entry} runs on the CUDA card unless asked otherwise, and no "
            f"CUDA device is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def trial_spec(spec: ExperimentSpec, trial: int) -> ExperimentSpec:
    """The spec of Monte-Carlo trial `trial`: fresh data AND solver streams
    (both seeds offset by the trial index; trial 0 is the spec verbatim)."""
    if trial == 0:
        return spec
    return dataclasses.replace(
        spec, seed=spec.seed + trial,
        data=dataclasses.replace(spec.data, seed=spec.data.seed + trial))


def _can_compile(spec: ExperimentSpec) -> bool:
    return spec.solver.name in _COMPILED_SOLVERS


def _check_trial_devices(spec: ExperimentSpec, dev: torch.device) -> None:
    """trial_devices of None or 1: one device.  More is a multi-device
    trial mesh (ROADMAP A11b); more than exist is a SpecError as well."""
    k = spec.backend.trial_devices
    if k is None or k == 1:
        return
    avail = torch.cuda.device_count() if dev.type == "cuda" else 1
    have = (f" (and only {avail} {dev.type} device(s) exist)" if k > avail
            else "")
    raise _not_ported(f"backend.trial_devices={k}, a trial mesh over several "
                      f"devices{have},", "A11b")


def batch_fit(spec: ExperimentSpec, n_trials: int, *, device="cuda",
              compiled: Optional[bool] = None) -> ResultSet:
    """Run `n_trials` independent Monte-Carlo trials of one spec on `device`.

    `compiled=None` runs every trial as one batched program (every built-in
    solver); `compiled=False` runs `n_trials` serial `fit` calls instead,
    the one form the shard_map backend runs yet (its compiled trial loop,
    ROADMAP A11b, raises NotPortedError).
    Trial t equals `fit(trial_spec(spec, t))` on the same device up to the
    order of fp32 sums; the batched icoa path ignores `solver.eps` and
    reports fit's stopping record as History.converged_at.  Each trial
    records its own ledger's bytes (under a byte budget with greedy_eta the
    trials' orders, and so their spends, may differ).  Under
    `BackendSpec(checks="raise")` the check sites fold into one error word
    per trial, read once at the end: a failure raises analysis.CheckError
    naming the site and the first failing trial."""
    dev = resolve_device(device, "repro_torch.api.batch_fit")
    spec.validate()
    if n_trials < 1:
        raise SpecError(f"need n_trials >= 1, got {n_trials}")
    _check_trial_devices(spec, dev)
    if spec.backend.name == "shard_map" and compiled is not False:
        raise _not_ported("batch_fit's compiled trial loop on the shard_map "
                          "backend (pass compiled=False for serial fits)",
                          "A11b")
    if compiled is None:
        compiled = _can_compile(spec)
    if not compiled:
        from repro_torch.api import fit  # api/__init__ imports this module

        return ResultSet(spec, [fit(trial_spec(spec, t), device=dev)
                                for t in range(n_trials)])
    if not _can_compile(spec):
        raise SpecError(f"no batched runner for solver {spec.solver.name!r}")
    with sanitize.error_scope(spec.backend.checks, n_trials):
        return _batch(spec, n_trials, dev)


def _batch(spec: ExperimentSpec, n_trials: int, dev: torch.device) -> ResultSet:
    if spec.backend.checks == "raise":
        # the JAX package's check of its padded trial vector; one card
        # needs no padding, so every index holds
        sanitize.check_in_bounds(
            torch.arange(n_trials, dtype=torch.int64, device=dev), n_trials,
            "local batch: padded trial indices (clamped tail)")

    dspec = spec.data
    groups = dspec.groups
    xcols, y, xcols_test, y_test = data_sources.make_trial_batch(
        dspec.source, dspec.n_train, dspec.n_test,
        [dspec.seed + t for t in range(n_trials)], groups, noise=dspec.noise,
        n_attrs=dspec.n_attrs, options=dspec.source_options, device=dev)
    if spec.backend.compute_dtype is not None:
        # validate() admits only bfloat16 / float32 / float64: torch's names
        dt = getattr(torch, spec.backend.compute_dtype)
        xcols, y, xcols_test, y_test = (a.to(dt) for a in (xcols, y,
                                                           xcols_test, y_test))
    family = spec.agent.resolve(n_cols=xcols.shape[-1])
    d, n = len(groups), dspec.n_train
    solver = spec.solver
    conv = None
    taps = {}
    if solver.name == "icoa":
        cfg = solver.icoa_config(spec.resolved_transport(),
                                 checks=spec.backend.checks,
                                 obs=spec.obs.normalized())
        params, f, weights, hist = icoa.run_scan(
            family, cfg, xcols, y, xcols_test, y_test,
            seeds=[spec.seed + t for t in range(n_trials)])
        trial_bytes = hist["trial_bytes"]
        conv = hist["converged_at"].cpu().tolist()
        taps = hist["taps"]               # (n_trials, n_sweeps, ...) each
    elif solver.name == "averaging":
        params, f, hist = baselines.averaging(
            family, xcols, y, xcols_test, y_test,
            seed=[spec.seed + t for t in range(n_trials)])
        hist = {k: v[:, None] for k, v in hist.items()}    # one record
        weights = torch.full((n_trials, d), 1.0 / d, dtype=f.dtype, device=dev)
        trial_bytes = [bytes_history(spec, d, n, 1)] * n_trials
    else:
        params, f, hist = baselines.residual_refitting(
            family, xcols, y, xcols_test, y_test, n_cycles=solver.n_sweeps,
            seed=[spec.seed + t for t in range(n_trials)],
            codec=spec.resolved_transport().codec)
        # the ring ensemble is the SUM of the agents (see api.solvers)
        weights = torch.ones((n_trials, d), dtype=f.dtype, device=dev)
        trial_bytes = [bytes_history(spec, d, n, solver.n_sweeps)] * n_trials

    # one device-to-host transfer per history field, not one per scalar
    host = {k: hist[k].cpu().tolist() for k in ("train_mse", "test_mse", "eta")}
    results = []
    for t in range(n_trials):
        history = History(train_mse=host["train_mse"][t],
                          test_mse=host["test_mse"][t], eta=host["eta"][t],
                          bytes_transmitted=list(trial_bytes[t]),
                          converged_at=None if conv is None else int(conv[t]))
        metrics = obs_taps.metrics_from_taps(
            spec.obs.normalized(), {k: v[t] for k, v in taps.items()})
        results.append(Result(spec=trial_spec(spec, t), family=family,
                              params=tree_map(lambda a: a[t], params),
                              weights=weights[t], f=f[t],
                              history=history, data=None, metrics=metrics))
    return ResultSet(spec, results)
