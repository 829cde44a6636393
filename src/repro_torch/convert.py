"""Carry data and solver state across from numpy (and so from the JAX
package) into the port's tensors.

With these a test starts the port's `sweep` from the exact state the JAX
package reached, or predicts with the JAX package's fitted coefficients:
the arrays keep their dtype and move to `device`.  `batch_from_numpy`
stacks numpy trial datasets into the (B, ...) tensors of icoa.run_scan, so
the port's batch and `jax.vmap` over the JAX package's run_scan see the same
arrays.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api.specs import Dataset
from repro_torch.core.icoa import ICOAState

__all__ = ["batch_from_numpy", "dataset_from_numpy", "params_from_numpy",
           "state_from_numpy"]


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


def batch_from_numpy(xcols, y, xcols_test, y_test, device="cpu"
                     ) -> Tuple[torch.Tensor, ...]:
    """(xcols (B, D, N, C), y (B, N), xcols_test (B, D, N_test, C), y_test
    (B, N_test)) tensors for icoa.run_scan: each argument is a sequence of
    per-trial arrays (or one array whose first axis is the trial), stacked."""
    out = tuple(_tensor(np.stack(a), device)
                for a in (xcols, y, xcols_test, y_test))
    if out[0].dim() != 4 or out[1].dim() != 2:
        raise ValueError(f"expected xcols (B, D, N, C) and y (B, N), got "
                         f"{tuple(out[0].shape)} and {tuple(out[1].shape)}")
    if len({a.shape[0] for a in out}) != 1:
        raise ValueError(f"trial axes differ: {[a.shape[0] for a in out]}")
    return out
