"""repro_torch.api — the entry point of the PyTorch port (twin of repro.api).

    from repro_torch import api

    spec = api.ExperimentSpec(solver=api.SolverSpec(name="icoa", use_kernel=True,
                                                    engine="fused"))
    result = api.fit(spec)                  # on the CUDA card
    result = api.fit(spec, device="cpu")    # on the CPU, plain PyTorch
    result.test_mse, result.history.eta, result.history.total_bytes

    rs = api.batch_fit(spec, n_trials=32)   # Monte Carlo, one batched program
    bytes_axis, mean, std = rs.curve("test_mse")

    mm = api.ExperimentSpec(solver=api.SolverSpec(alpha=100.0, delta=0.01))
    api.fit(mm).minimax_upper_bound()       # Minimax Protection, eq. 28

    result.save("run/")                     # the JAX package's layout
    again = api.load("run/")                # either package's results

`fit` and `batch_fit` run on the card unless the caller asks for the CPU:
with no CUDA device they raise instead of carrying on.  On the card,
`use_kernel=True` sends every product the JAX package computes in a Pallas
kernel through the hand-written CUDA kernels of repro_torch.kernels — the
batched kernels for `batch_fit`.  Every solver of the JAX package runs on
every transport of it (topology, codec, byte budget and policy): icoa on
the dense, incremental and fused engines at any alpha and delta, and the
averaging and residual-refitting baselines, with every agent family
(polynomial, linear, rff, mlp).  A FaultSpec (drops with retries,
corruption, stragglers, crash and rejoin) runs on the incremental and
fused engines, single and batched:

    api.ExperimentSpec(solver=api.SolverSpec(engine="fused"),
                       faults=api.FaultSpec(seed=5, drop_rate=0.3,
                                            max_retries=2,
                                            crash=((1, 1, 3),)))
`sweep(spec, grid, trials=k)` runs a grid of specs, each as k trials.
Data are drawn on the device from the JAX package's key stream, so
`fit(spec)` reproduces `repro.api.fit(spec)` from the seed on.

`BackendSpec(checks="raise")` turns on the sanitizer rail
(repro_torch.analysis.sanitize) in fit, batch_fit, sweep and stream_fit:
NaN from a lossy codec, a singular SMW pivot or a trial index off the
batch raises analysis.CheckError naming the site (and the trial of a
batch); a healthy run gives the off mode's bits.

An `ObsSpec` of taps fills `Result.metrics` (every engine, single and
batched, under any transport and FaultSpec); `stream_fit(StreamSpec(...))`
runs the online loop (repro_torch.stream) on the card:

    r = api.fit(api.ExperimentSpec(obs=api.ObsSpec(taps=("eta", "accepts"))))
    r.metrics["accepts"]                    # (n_sweeps, D)
    s = api.stream_fit(api.StreamSpec(window=4096, chunk=64,
                                      resweep_every=2048,
                                      total_instances=16384))
    s.eta, s.test_mse, s.total_bytes
"""
from __future__ import annotations

from typing import Optional

from repro_torch.analysis import sanitize
from repro_torch.api.io import load_result as load
from repro_torch.api.io import save_result
from repro_torch.api.result import History, Result, ResultSet
from repro_torch.api.runner import batch_fit, resolve_device, trial_spec
from repro_torch.api.solvers import (SOLVERS, comm_floats_per_sweep,
                                     register_solver, run_solver)
from repro_torch.api.specs import (AgentSpec, BackendSpec, DataSpec, Dataset,
                                   ExperimentSpec, FaultError, FaultSpec,
                                   NotPortedError, ObsError, ObsSpec,
                                   SolverSpec, SpecError, StreamSpec,
                                   TransportSpec, spec_from_dict, spec_to_dict,
                                   stream_spec_from_dict, stream_spec_to_dict)
from repro_torch.api.sweep import grid_specs, spec_with, sweep, zip_specs
from repro_torch.obs.taps import Metrics
from repro_torch.obs.trace import trace as _obs_span
from repro_torch.stream.run import StreamResult, stream_fit

__all__ = [
    "AgentSpec", "BackendSpec", "DataSpec", "Dataset", "ExperimentSpec",
    "FaultError", "FaultSpec", "History", "Metrics", "NotPortedError",
    "ObsError", "ObsSpec", "Result", "ResultSet", "SOLVERS", "SolverSpec",
    "SpecError", "StreamResult", "StreamSpec", "TransportSpec", "batch_fit",
    "comm_floats_per_sweep", "fit", "grid_specs", "load", "register_solver",
    "run_solver", "save_result", "spec_from_dict", "spec_to_dict",
    "spec_with", "stream_fit", "stream_spec_from_dict", "stream_spec_to_dict",
    "sweep", "trial_spec", "zip_specs",
]


def fit(spec: ExperimentSpec, *, device="cuda",
        data: Optional[Dataset] = None) -> Result:
    """Run one experiment end to end on `device`: build the data from the
    spec (or take `data`, moved to `device`), resolve the agent family, run
    the registered solver and return the standardised Result.  Under
    `BackendSpec(checks="raise")` the solver's check sites are on, and a
    failed one raises analysis.CheckError naming its site."""
    dev = resolve_device(device, "repro_torch.api.fit")
    spec.validate()
    with _obs_span("api.fit", solver=spec.solver.name,
                   backend=spec.backend.name):
        if data is None:
            data = spec.data.build(dev)
        else:
            data = Dataset(data.xcols.to(dev), data.y.to(dev),
                           data.xcols_test.to(dev), data.y_test.to(dev),
                           data.groups)
        family = spec.agent.resolve(n_cols=data.xcols.shape[-1])
        with sanitize.error_scope(spec.backend.checks):
            return run_solver(spec, data, family)
