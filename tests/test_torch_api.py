"""repro_torch.api against repro.api, the spec layer, and import hygiene.

  * `repro_torch.api.fit(spec, device="cpu", data=...)` against
    `repro.api.solvers.run_solver(spec, data, family)` on the same float64
    arrays: histories at 1e-10, bytes exactly equal;
  * a spec JSON written by `repro` loads in `repro_torch`, and back;
  * `fit(spec)` with no CUDA device raises instead of running on the CPU;
  * each spec field the slice does not implement raises NotPortedError
    naming its ROADMAP item;
  * `Result.predict` with the JAX package's fitted params carried across
    agrees with the JAX package's;
  * src/repro_torch and chip_smoke.py import neither jax nor repro, and the
    port runs with jax made unimportable.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.agents import PolynomialFamily as JPoly
from repro.api.solvers import run_solver
from repro.api.specs import Dataset as JDataset
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.agents import PolynomialFamily as TPoly

REPO = Path(__file__).resolve().parents[1]


def _spec_pair(**solver):
    kw = dict(n_sweeps=4, **solver)
    data = dict(n_train=400, n_test=300)
    return (japi.ExperimentSpec(data=japi.DataSpec(**data),
                                solver=japi.SolverSpec(**kw)),
            tapi.ExperimentSpec(data=tapi.DataSpec(**data),
                                solver=tapi.SolverSpec(**kw)))


@pytest.fixture(scope="module")
def jax_fits():
    """{engine: (jax Result, numpy arrays)} — float64 runs of the JAX api."""
    out = {}
    with jax.enable_x64(True):
        for engine in ("incremental", "fused"):
            jspec, _ = _spec_pair(engine=engine)
            data = jspec.data.build()
            arrays = [np.asarray(a) for a in data[:4]]
            jdata = JDataset(*map(jnp.asarray, arrays), data.groups)
            res = run_solver(jspec, jdata, JPoly(n_cols=1, degree=4))
            out[engine] = (res, arrays, data.groups)
    japi.clear_dataset_cache()
    return out


@pytest.mark.parametrize("engine", ["incremental", "fused"])
def test_fit_matches_jax_run_solver(jax_fits, engine):
    jres, arrays, groups = jax_fits[engine]
    _, tspec = _spec_pair(engine=engine)
    data = convert.dataset_from_numpy(*arrays, groups, device="cpu")
    tres = tapi.fit(tspec, device="cpu", data=data)
    for key in ("train_mse", "test_mse", "eta"):
        np.testing.assert_allclose(getattr(tres.history, key),
                                   getattr(jres.history, key), rtol=1e-10,
                                   err_msg=key)
    assert tres.history.bytes_transmitted == jres.history.bytes_transmitted
    assert tres.history.converged_at == jres.history.converged_at
    assert tres.params.dtype == torch.float64
    np.testing.assert_allclose(tres.weights.numpy(), np.asarray(jres.weights),
                               rtol=1e-9, atol=1e-12)
    per_sweep = tapi.comm_floats_per_sweep(tspec.solver, 5, 400) * 8
    assert tres.history.bytes_transmitted[1:] == [float(per_sweep)] * 4
    assert per_sweep == japi.comm_floats_per_sweep(
        japi.SolverSpec(engine=engine), 5, 400) * 8


def test_predict_with_jax_params(jax_fits):
    jres, arrays, groups = jax_fits["fused"]
    x = np.random.default_rng(0).standard_normal((50, 5))
    tres = tapi.Result(spec=tapi.ExperimentSpec(), family=TPoly(n_cols=1, degree=4),
                       params=convert.params_from_numpy(np.asarray(jres.params)),
                       weights=torch.from_numpy(np.array(jres.weights)),
                       f=torch.from_numpy(np.array(jres.f)),
                       history=tapi.History())
    with jax.enable_x64(True):
        want = np.asarray(jres.predict(jnp.asarray(x)))
        want_mse = jres.mse(jnp.asarray(x), jnp.asarray(x[:, 0]))
    np.testing.assert_allclose(tres.predict(torch.from_numpy(x)).numpy(), want,
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tres.mse(torch.from_numpy(x), torch.from_numpy(x[:, 0])),
                               want_mse, rtol=1e-10)


def test_spec_json_written_by_repro_loads():
    jspec = japi.ExperimentSpec(
        data=japi.DataSpec(source="correlated_linear", n_attrs=7, n_train=123,
                           source_options=(("rho", 0.9),)),
        agent=japi.AgentSpec(options=(("degree", 3),)),
        solver=japi.SolverSpec(engine="fused", use_kernel=True, n_sweeps=3),
        seed=4)
    text = json.dumps(japi.spec_to_dict(jspec))
    tspec = tapi.spec_from_dict(json.loads(text))
    assert tspec == tapi.ExperimentSpec(
        data=tapi.DataSpec(source="correlated_linear", n_attrs=7, n_train=123,
                           source_options=(("rho", 0.9),)),
        agent=tapi.AgentSpec(options=(("degree", 3),)),
        solver=tapi.SolverSpec(engine="fused", use_kernel=True, n_sweeps=3),
        seed=4)
    assert json.dumps(tapi.spec_to_dict(tspec)) == text
    tspec.validate()
    with pytest.raises(tapi.SpecError, match="unrecognised"):
        tapi.spec_from_dict({"solver": {"nme": "icoa"}})


def test_fit_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.fit(tapi.ExperimentSpec())


@pytest.mark.parametrize("change,item", [
    (dict(solver=tapi.SolverSpec(alpha=20.0)), "A8"),
    (dict(solver=tapi.SolverSpec(delta=0.05)), "A8"),
    (dict(solver=tapi.SolverSpec(name="averaging")), "A8"),
    (dict(solver=tapi.SolverSpec(engine="dense")), "A4"),
    (dict(transport=tapi.TransportSpec(codec="int8_affine")), "A9"),
    (dict(transport=tapi.TransportSpec(topology="ring")), "A9"),
    (dict(transport=tapi.TransportSpec(byte_budget=1e6)), "A9"),
    (dict(faults=tapi.FaultSpec(drop_rate=0.1)), "A12"),
    (dict(obs=tapi.ObsSpec(taps=("eta",))), "A13"),
    (dict(backend=tapi.BackendSpec(checks="raise")), "A15"),
    (dict(backend=tapi.BackendSpec(name="shard_map")), "A11"),
    (dict(agent=tapi.AgentSpec(family="linear")), "A2"),
    (dict(agent=tapi.AgentSpec(family="mlp")), "A16"),
    (dict(data=tapi.DataSpec(source="cosine")), "A7"),
    (dict(data=tapi.DataSpec(partition="round_robin", n_agents=5)), "A7"),
])
def test_unported_fields_raise_with_roadmap_item(change, item):
    spec = tapi.ExperimentSpec(**change)
    with pytest.raises(tapi.NotPortedError, match=rf"ROADMAP {item}\b"):
        spec.validate()
    with pytest.raises(tapi.NotPortedError, match=rf"ROADMAP {item}\b"):
        tapi.fit(spec, device="cpu")


def test_invalid_fields_raise_spec_error():
    for bad in (tapi.SolverSpec(engine="warp"), tapi.SolverSpec(alpha=0.5),
                tapi.SolverSpec(n_sweeps=0)):
        with pytest.raises(tapi.SpecError):
            tapi.ExperimentSpec(solver=bad).validate()
    with pytest.raises(tapi.SpecError):
        tapi.ExperimentSpec(transport=tapi.TransportSpec(codec="zip")).validate()


def test_fit_builds_data_from_spec():
    spec = tapi.ExperimentSpec(data=tapi.DataSpec(n_train=300, n_test=200),
                               solver=tapi.SolverSpec(n_sweeps=3, engine="fused",
                                                      use_kernel=True))
    res = tapi.fit(spec, device="cpu")
    assert res.data.xcols.shape == (5, 300, 1) and res.f.shape == (5, 300)
    assert len(res.history.eta) == 4 and res.history.bytes_transmitted[0] == 0.0
    assert np.isfinite(res.test_mse) and res.test_mse < 0.05
    again = tapi.fit(spec, device="cpu")
    assert again.history.eta == res.history.eta          # same seed, same run


# ----------------------------------------------------------------- hygiene


def _port_files():
    return sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax_and_no_repro():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(REPO)}:{node.lineno} {name}")
    assert len(_port_files()) > 20
    assert bad == []


def test_port_runs_with_jax_unimportable():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "from repro_torch import api\n"
        "spec = api.ExperimentSpec(data=api.DataSpec(n_train=200, n_test=100),\n"
        "    solver=api.SolverSpec(n_sweeps=2, engine='fused', use_kernel=True))\n"
        "r = api.fit(spec, device='cpu')\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
        "print('ok', len(r.history.eta))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok 3"
