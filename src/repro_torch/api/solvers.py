"""Solver registry: one `run_solver(spec, data, family) -> Result` per
algorithm (twin of repro.api.solvers): `icoa` and the paper's two
baselines, `averaging` and `residual_refitting`, on the local backend and
on the shard_map backend, one agent a rank of a gloo group
(core.distributed).
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch

from repro_torch.api.result import History, Result
from repro_torch.api.specs import Dataset, ExperimentSpec, SolverSpec, SpecError
from repro_torch.core import baselines, distributed, icoa
from repro_torch.core import covariance as cov
from repro_torch.obs import taps as obs_taps
from repro_torch.transport import ledger as ledger_mod

__all__ = ["SOLVERS", "register_solver", "comm_floats_per_sweep", "run_solver"]

SOLVERS: Dict[str, Callable[..., Result]] = {}


def register_solver(name: str):
    def deco(fn):
        SOLVERS[name] = fn
        return fn

    return deco


def run_solver(spec: ExperimentSpec, data: Dataset, family) -> Result:
    if spec.solver.name not in SOLVERS:
        raise SpecError(f"unknown solver {spec.solver.name!r}; "
                        f"registered: {sorted(SOLVERS)}")
    return SOLVERS[spec.solver.name](spec, data, family)


def comm_floats_per_sweep(solver: SolverSpec, d: int, n: int) -> int:
    """Analytic residual-transmission cost of ONE sweep/cycle (floats):
    averaging 0; residual refit N*D; icoa dense m*D^2; icoa row-wise
    (incremental / fused engine, or row_broadcast) 2*m*D, m = N/alpha, plus
    the diagonal variance scalars under compression.  The measured ledger
    equals this times the codec itemsize for exact codecs on `full`."""
    if solver.name == "averaging":
        return 0
    if solver.name == "residual_refitting":
        return n * d
    row_wise = solver.row_broadcast or solver.engine in ("incremental", "fused")
    m = cov.subsample_size(n, solver.alpha) if solver.alpha > 1.0 else n
    diag = (2 * d if row_wise else d * d) if solver.alpha > 1.0 else 0
    if row_wise:
        return 2 * m * d + diag
    return m * d * d + diag


def bytes_history(spec: ExperimentSpec, d: int, n: int, n_records: int) -> List[float]:
    """Byte history of the solvers without a sweep ledger: averaging moves
    nothing (one record, 0); residual refitting charges one ensemble sum per
    agent update, every cycle (no initial record)."""
    if spec.solver.name == "averaging":
        return [0.0] * n_records
    per_cycle = ledger_mod.refit_cycle_bytes(spec.resolved_transport(), d, n)
    return [float(per_cycle)] * n_records


def _agents_one_a_rank(spec: ExperimentSpec, d: int) -> None:
    """The shard_map backend runs exactly one agent a rank (group rank ==
    agent id), as the JAX package runs one a device: n_devices is None or
    the agent count."""
    if spec.backend.n_devices not in (None, d):
        raise SpecError(
            f"shard_map runs one agent per device: n_devices must be {d} "
            f"(the agent count) or None, got {spec.backend.n_devices}")


@register_solver("icoa")
def _fit_icoa(spec: ExperimentSpec, data: Dataset, family) -> Result:
    cfg = spec.solver.icoa_config(spec.resolved_transport(),
                                  checks=spec.backend.checks,
                                  obs=spec.obs.normalized())
    if spec.backend.name == "shard_map":
        _agents_one_a_rank(spec, data.xcols.shape[0])
        params, weights, hist = distributed.run_distributed(
            family, cfg, data.xcols, data.y, data.xcols_test, data.y_test,
            seed=spec.seed)
        f = family.predict(params, data.xcols)
    else:
        state, weights, hist = icoa.run(family, cfg, data.xcols, data.y,
                                        data.xcols_test, data.y_test,
                                        seed=spec.seed)
        params, f = state.params, state.f
    history = History(train_mse=hist["train_mse"], test_mse=hist["test_mse"],
                      eta=hist["eta"], bytes_transmitted=list(hist["bytes"]),
                      converged_at=len(hist["train_mse"]) - 1)
    return Result(spec=spec, family=family, params=params,
                  weights=weights, f=f, history=history, data=data,
                  metrics=obs_taps.metrics_from_taps(cfg.obs, hist["taps"]))


@register_solver("averaging")
def _fit_averaging(spec: ExperimentSpec, data: Dataset, family) -> Result:
    d = data.xcols.shape[0]
    if spec.backend.name == "shard_map":
        _agents_one_a_rank(spec, d)
        params, f = distributed.run_averaging_distributed(
            family, data.xcols, data.y, seed=spec.seed)
        weights = torch.ones((d,), dtype=f.dtype, device=f.device) / d
        # the records of the JAX package's shard_map branch: w @ f
        hist = {"train_mse": float(torch.mean((data.y - weights @ f) ** 2)),
                "eta": float(baselines._eta(f, data.y))}
        if data.y_test.shape[0]:
            ft = family.predict(params, data.xcols_test)
            hist["test_mse"] = float(torch.mean((data.y_test - weights @ ft) ** 2))
    else:
        params, f, hist = baselines.averaging(family, data.xcols, data.y,
                                              data.xcols_test, data.y_test,
                                              seed=spec.seed)
        weights = torch.ones((d,), dtype=f.dtype, device=f.device) / d
    history = History(train_mse=[hist["train_mse"]], eta=[hist["eta"]],
                      bytes_transmitted=bytes_history(spec, d, data.y.shape[0], 1))
    if "test_mse" in hist:
        history.test_mse.append(hist["test_mse"])
    return Result(spec=spec, family=family, params=params, weights=weights,
                  f=f, history=history, data=data)


@register_solver("residual_refitting")
def _fit_refit(spec: ExperimentSpec, data: Dataset, family) -> Result:
    d, n = data.xcols.shape[0], data.y.shape[0]
    codec = spec.resolved_transport().codec
    if spec.backend.name == "shard_map":
        _agents_one_a_rank(spec, d)
        params, f, hist = distributed.run_refit_distributed(
            family, data.xcols, data.y, data.xcols_test, data.y_test,
            n_cycles=spec.solver.n_sweeps, seed=spec.seed, codec=codec,
            checks=spec.backend.checks)
    else:
        params, f, hist = baselines.residual_refitting(
            family, data.xcols, data.y, data.xcols_test, data.y_test,
            n_cycles=spec.solver.n_sweeps, seed=spec.seed, codec=codec)
    history = History(train_mse=hist["train_mse"],
                      test_mse=hist.get("test_mse", []), eta=hist["eta"],
                      bytes_transmitted=bytes_history(spec, d, n,
                                                      len(hist["train_mse"])))
    # the ring ensemble is the SUM of the agents: literal ones keep
    # `weights @ f` the combination rule of every solver
    weights = torch.ones((d,), dtype=f.dtype, device=f.device)
    return Result(spec=spec, family=family, params=params, weights=weights,
                  f=f, history=history, data=data)
