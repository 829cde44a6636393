"""repro_torch.api — the entry point of the PyTorch port (twin of repro.api).

    from repro_torch import api

    spec = api.ExperimentSpec(solver=api.SolverSpec(name="icoa", use_kernel=True,
                                                    engine="fused"))
    result = api.fit(spec)                  # on the CUDA card
    result = api.fit(spec, device="cpu")    # on the CPU, plain PyTorch
    result.test_mse, result.history.eta, result.history.total_bytes

`fit` runs on the card unless the caller asks for the CPU: with no CUDA
device it raises instead of carrying on.  On the card, `use_kernel=True`
sends every product the JAX package computes in a Pallas kernel through the
hand-written CUDA kernels of repro_torch.kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.api.result import History, Result
from repro_torch.api.solvers import (SOLVERS, comm_floats_per_sweep,
                                     register_solver, run_solver)
from repro_torch.api.specs import (AgentSpec, BackendSpec, DataSpec, Dataset,
                                   ExperimentSpec, FaultSpec, NotPortedError,
                                   ObsSpec, SolverSpec, SpecError,
                                   TransportSpec, spec_from_dict, spec_to_dict)

__all__ = [
    "AgentSpec", "BackendSpec", "DataSpec", "Dataset", "ExperimentSpec",
    "FaultSpec", "History", "NotPortedError", "ObsSpec", "Result", "SOLVERS",
    "SolverSpec", "SpecError", "TransportSpec", "comm_floats_per_sweep",
    "fit", "register_solver", "run_solver", "spec_from_dict", "spec_to_dict",
]


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch.api.fit runs on the CUDA card unless asked otherwise, "
            "and no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def fit(spec: ExperimentSpec, *, device="cuda",
        data: Optional[Dataset] = None) -> Result:
    """Run one experiment end to end on `device`: build the data from the
    spec (or take `data`, moved to `device`), resolve the agent family, run
    the registered solver and return the standardised Result."""
    dev = _resolve_device(device)
    spec.validate()
    if data is None:
        data = spec.data.build(dev)
    else:
        data = Dataset(data.xcols.to(dev), data.y.to(dev),
                       data.xcols_test.to(dev), data.y_test.to(dev),
                       data.groups)
    family = spec.agent.resolve(n_cols=data.xcols.shape[-1])
    return run_solver(spec, data, family)
