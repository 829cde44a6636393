"""Grid sweeps over ExperimentSpecs — the paper's trade-off curves in one
call (twin of repro.api.sweep).

A grid maps dotted spec paths to value lists:

    sweep(base, {"solver.n_sweeps": [2, 5, 10], "data.noise": [0.0, 0.1]})

runs the 6-point product grid and returns one Result per spec (in product
order, last axis fastest). `grid_specs` exposes the spec enumeration alone so
callers that need per-run timing or custom scheduling can drive `fit`
themselves. `zip_specs` varies several fields TOGETHER (paired, not crossed).
The paper's trade-off grids run: `{"solver.alpha": [1, 20, 100],
"solver.delta": [0, 0.01]}`, the solver names themselves, or the
transport's axes (`{"transport.codec": ["exact_f64", "int8_affine"],
"transport.topology": ["full", "ring"]}`), the agent families
(`{"agent.family": ["polynomial", "mlp"]}`) or a fault model's rates
(`{"faults.drop_rate": [0.0, 0.3]}`).  A grid point this port does not
run yet (obs taps, say) raises its NotPortedError when it is fitted.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Iterator, List, Mapping, Optional, Sequence

from repro_torch.api.specs import ExperimentSpec, SpecError

__all__ = ["spec_with", "grid_specs", "zip_specs", "sweep"]


def spec_with(spec: ExperimentSpec, path: str, value: Any) -> ExperimentSpec:
    """Functional update of one dotted field, e.g. ("solver.n_sweeps", 5)."""
    head, _, rest = path.partition(".")
    if not hasattr(spec, head):
        raise SpecError(f"spec has no field {head!r} (path {path!r})")
    if not rest:
        return dataclasses.replace(spec, **{head: value})
    return dataclasses.replace(spec, **{head: spec_with(getattr(spec, head), rest, value)})


def grid_specs(base: ExperimentSpec,
               grid: Mapping[str, Sequence[Any]]) -> Iterator[ExperimentSpec]:
    """Product grid: every combination of the listed values, last key fastest."""
    paths = list(grid)
    for combo in itertools.product(*(grid[p] for p in paths)):
        spec = base
        for path, value in zip(paths, combo):
            spec = spec_with(spec, path, value)
        yield spec


def zip_specs(base: ExperimentSpec,
              grid: Mapping[str, Sequence[Any]]) -> Iterator[ExperimentSpec]:
    """Paired sweep: i-th spec takes the i-th value of EVERY list."""
    paths = list(grid)
    lengths = {len(grid[p]) for p in paths}
    if len(lengths) > 1:
        raise SpecError(f"zip_specs needs equal-length value lists, got "
                        f"{ {p: len(grid[p]) for p in paths} }")
    for combo in zip(*(grid[p] for p in paths)):
        spec = base
        for path, value in zip(paths, combo):
            spec = spec_with(spec, path, value)
        yield spec


def sweep(base: ExperimentSpec, grid: Mapping[str, Sequence[Any]],
          paired: bool = False, trials: Optional[int] = None, *,
          device="cuda") -> List[Any]:
    """Fit every spec in the grid on `device`; results in enumeration order.

    `trials=None` (default): one `fit` per spec — a list of `Result`s.
    `trials=k`: every grid point becomes k Monte-Carlo trials through
    `batch_fit` (one batched program per spec) — a list of `ResultSet`s:

        [(rs.spec.solver.n_sweeps, *rs.curve()) for rs in sweep(..., trials=8)]
    """
    from repro_torch.api import batch_fit, fit  # api/__init__ imports this module

    specs = zip_specs(base, grid) if paired else grid_specs(base, grid)
    if trials is None:
        return [fit(spec, device=device) for spec in specs]
    return [batch_fit(spec, trials, device=device) for spec in specs]
