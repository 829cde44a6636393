"""Standardised run output: `History` and `Result` (twin of repro.api.result).

`History` holds one entry per record: train_mse, test_mse, eta (the MSE of
the optimally weighted ensemble, paper eq. 11) and bytes_transmitted (the
ledger bytes of the sweep that produced the record; record 0 is 0).
`ResultSet` is the Monte-Carlo aggregate of api.batch_fit: every trial of
one spec, with mean/std trade-off curves over the trial axis.
`Result.metrics` holds the run's obs taps (obs.Metrics; None without
taps), in memory only: result io never writes it, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.specs import Dataset, ExperimentSpec
from repro_torch.core import covariance as cov
from repro_torch.core import ensemble, icoa, minimax
from repro_torch.obs.taps import Metrics

__all__ = ["History", "Result", "ResultSet"]


@dataclasses.dataclass
class History:
    train_mse: List[float] = dataclasses.field(default_factory=list)
    test_mse: List[float] = dataclasses.field(default_factory=list)
    eta: List[float] = dataclasses.field(default_factory=list)
    bytes_transmitted: List[float] = dataclasses.field(default_factory=list)
    # record where the serial eps rule stops (|eta_k - eta_{k-1}| < eps over
    # post-sweep records): the last record of a fit, which truncates there;
    # batch_fit runs the full static schedule and reports where fit WOULD
    # have stopped instead
    converged_at: Optional[int] = None

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_transmitted))

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "History":
        series = {f.name: list(d.get(f.name, []))
                  for f in dataclasses.fields(cls) if f.name != "converged_at"}
        conv = d.get("converged_at")
        return cls(converged_at=None if conv is None else int(conv), **series)


@dataclasses.dataclass
class Result:
    spec: ExperimentSpec
    family: Any               # resolved agent family
    params: Any               # stacked agent params (D, P); a dict for mlp
    weights: torch.Tensor     # (D,) combination weights
    f: torch.Tensor           # (D, N_train) final per-agent train predictions
    history: History
    data: Optional[Dataset] = None
    metrics: Optional[Metrics] = None   # obs taps (spec.obs); None when off

    @property
    def groups(self) -> List[List[int]]:
        return self.spec.data.groups

    @property
    def train_mse(self) -> float:
        return self.history.train_mse[-1]

    @property
    def test_mse(self) -> Optional[float]:
        return self.history.test_mse[-1] if self.history.test_mse else None

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """Ensemble prediction for a full (N, M) covariate matrix: slice each
        agent's columns, predict per agent, combine with the run's weights."""
        xcols = torch.stack([x[:, g] for g in self.groups])
        return ensemble.combine(self.weights,
                                self.family.predict(self.params, xcols))

    def mse(self, x: torch.Tensor, y: torch.Tensor) -> float:
        return float(torch.mean((y - self.predict(x)) ** 2))

    def minimax_upper_bound(self, alpha: Optional[float] = None) -> float:
        """Paper eq. 28: the high-probability test-error upper bound at
        compression rate `alpha` (default: the rate this run used), from
        the pre-cooperation residual covariance, with the run's own
        inner-solver budget (SolverSpec.minimax_steps / minimax_lr)."""
        if self.data is None:
            raise ValueError("minimax_upper_bound needs the in-memory Dataset "
                             "(batch results drop it; use fit or rebuild "
                             "spec.data)")
        if alpha is None:
            alpha = self.spec.solver.alpha
        state0 = icoa.init_state(self.family, self.data.xcols, self.data.y)
        a_ini = cov.gram(self.data.y[None, :] - state0.f)
        return minimax.upper_bound(a_ini, alpha, self.data.y.shape[0],
                                   steps=self.spec.solver.minimax_steps,
                                   lr=self.spec.solver.minimax_lr)

    def save(self, directory: str) -> str:
        """Checkpoint params / weights / f with the spec and the history as
        JSON; restore with `repro_torch.api.load(directory)` (or the JAX
        package's `repro.api.load`)."""
        from repro_torch.api import io  # io imports this module

        return io.save_result(directory, self)


@dataclasses.dataclass
class ResultSet:
    """Monte-Carlo aggregate: every trial of ONE spec (api.batch_fit), twin
    of repro.api.result.ResultSet.

    Each element is a full per-trial `Result` whose spec carries that trial's
    seeds (trial t offsets both `seed` and `data.seed` by t).  Aggregates are
    computed over the trial axis; histories are truncated to the shortest
    trial before stacking (serial trials may stop early on eps — the batched
    runner always records the full static schedule).

        bytes, mean, std = rs.curve("test_mse")   # trade-off curve +- std
    """

    spec: ExperimentSpec          # the base spec (trial 0 runs it verbatim)
    results: List[Result]

    def __len__(self) -> int:
        return len(self.results)

    def __iter__(self):
        return iter(self.results)

    def __getitem__(self, i: int) -> Result:
        return self.results[i]

    @property
    def n_records(self) -> int:
        return min(len(r.history.train_mse) for r in self.results)

    def stack(self, field: str = "test_mse") -> np.ndarray:
        """(n_trials, n_records) history matrix for one History field."""
        t = self.n_records
        return np.asarray([getattr(r.history, field)[:t] for r in self.results])

    def mean(self, field: str = "test_mse") -> np.ndarray:
        return self.stack(field).mean(axis=0)

    def std(self, field: str = "test_mse") -> np.ndarray:
        return self.stack(field).std(axis=0)

    @property
    def converged_sweeps(self) -> List[Optional[int]]:
        """Per-trial record index where the serial eps rule stops."""
        return [r.history.converged_at for r in self.results]

    @property
    def cumulative_bytes(self) -> np.ndarray:
        """Cumulative measured wire bytes per record — defined only when the
        per-trial ledgers agree (always without a byte budget; under one
        with greedy_eta the trials' orders may differ); a divergence names
        the first offending trial and record."""
        b = self.stack("bytes_transmitted")
        scale = max(float(np.max(np.abs(b))), 1.0)
        dev = np.abs(b - b[0:1])
        if np.max(dev) > 1e-9 * scale:
            trial, record = np.unravel_index(int(np.argmax(dev)), dev.shape)
            raise ValueError(
                f"per-trial byte ledgers diverge: trial {trial} record "
                f"{record} transmitted {b[trial, record]:g} bytes vs trial 0's "
                f"{b[0, record]:g}; there is no single byte axis — use "
                f"np.cumsum(rs.stack('bytes_transmitted'), axis=1) for "
                f"per-trial curves")
        return np.cumsum(b[0])

    def curve(self, field: str = "test_mse"
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The paper's trade-off curve: (cumulative_bytes, mean, std)."""
        return self.cumulative_bytes, self.mean(field), self.std(field)

    @property
    def test_mse_mean(self) -> float:
        return float(self.mean("test_mse")[-1])

    @property
    def test_mse_std(self) -> float:
        return float(self.std("test_mse")[-1])
