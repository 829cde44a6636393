"""Solver registry: one `run_solver(spec, data, family) -> Result` per
algorithm (twin of repro.api.solvers).  This slice registers `icoa` on the
local backend; averaging and residual refitting wait for ROADMAP A8.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.api.result import History, Result
from repro_torch.api.specs import Dataset, ExperimentSpec, SolverSpec, SpecError
from repro_torch.core import covariance as cov
from repro_torch.core import icoa

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


@register_solver("icoa")
def _fit_icoa(spec: ExperimentSpec, data: Dataset, family) -> Result:
    cfg = spec.solver.icoa_config(spec.resolved_transport())
    state, weights, hist = icoa.run(family, cfg, data.xcols, data.y,
                                    data.xcols_test, data.y_test)
    history = History(train_mse=hist["train_mse"], test_mse=hist["test_mse"],
                      eta=hist["eta"], bytes_transmitted=list(hist["bytes"]),
                      converged_at=len(hist["train_mse"]) - 1)
    return Result(spec=spec, family=family, params=state.params,
                  weights=weights, f=state.f, history=history, data=data)
