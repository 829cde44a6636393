"""Carry data and solver state across from numpy (and so from the JAX
package) into the port's tensors.

With these a test starts the port's `sweep` from the exact state the JAX
package reached, or predicts with the JAX package's fitted coefficients:
the arrays keep their dtype and move to `device`.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.api.specs import Dataset
from repro_torch.core.icoa import ICOAState

__all__ = ["dataset_from_numpy", "params_from_numpy", "state_from_numpy"]


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def dataset_from_numpy(xcols, y, xcols_test, y_test,
                       groups: Sequence[Sequence[int]], device="cpu") -> Dataset:
    """A Dataset from (D, N, C) / (N,) / (D, N_test, C) / (N_test,) arrays."""
    g: List[List[int]] = [list(map(int, grp)) for grp in groups]
    return Dataset(_tensor(xcols, device), _tensor(y, device),
                   _tensor(xcols_test, device), _tensor(y_test, device), g)


def params_from_numpy(params, device="cpu") -> torch.Tensor:
    """The JAX package's `Result.params` — (D, P) polynomial coefficients."""
    p = _tensor(params, device)
    if p.dim() != 2:
        raise ValueError(f"expected (D, P) stacked params, got {tuple(p.shape)}")
    return p


def state_from_numpy(params, f, device="cpu") -> ICOAState:
    """An ICOAState from the JAX package's stacked params (D, P) and
    prediction matrix f (D, N)."""
    return ICOAState(params=params_from_numpy(params, device),
                     f=_tensor(f, device))
