"""Standardised run output: `History` and `Result` (twin of repro.api.result).

`History` holds one entry per record: train_mse, test_mse, eta (the MSE of
the optimally weighted ensemble, paper eq. 11) and bytes_transmitted (the
ledger bytes of the sweep that produced the record; record 0 is 0).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch

from repro_torch.api.specs import Dataset, ExperimentSpec
from repro_torch.core import ensemble

__all__ = ["History", "Result"]


@dataclasses.dataclass
class History:
    train_mse: List[float] = dataclasses.field(default_factory=list)
    test_mse: List[float] = dataclasses.field(default_factory=list)
    eta: List[float] = dataclasses.field(default_factory=list)
    bytes_transmitted: List[float] = dataclasses.field(default_factory=list)
    converged_at: Optional[int] = None   # record where the eps rule stopped

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_transmitted))


@dataclasses.dataclass
class Result:
    spec: ExperimentSpec
    family: Any               # resolved agent family
    params: torch.Tensor      # (D, P) stacked agent params
    weights: torch.Tensor     # (D,) combination weights
    f: torch.Tensor           # (D, N_train) final per-agent train predictions
    history: History
    data: Optional[Dataset] = None

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
