"""repro_torch.api against repro.api, the spec layer, and import hygiene.

  * `repro_torch.api.fit(spec, device="cpu", data=...)` against
    `repro.api.solvers.run_solver(spec, data, family)` on the same float64
    arrays: histories at 1e-10, bytes exactly equal;
  * `repro_torch.api.fit(spec, device="cpu")` against `repro.api.fit(spec)`
    from the spec alone (both draw the data from the seed): in float64
    (torch's default dtype float64, jax.enable_x64) histories at 1e-10 and
    bytes equal, for the default spec, `cosine`, `correlated_linear` under
    `blocks` (two columns an agent) and `overlapping`, `round_robin`,
    `random` and the `linear` family (whose test MSE record is held to
    the JAX package's own spread under a one-ulp change of its data, or to
    1e-10 where that is larger); in float32 the default spec and cosine at
    F32_TOL, correlated_blocks and the linear family to that spread
    (ROADMAP P4);
  * a Result saved by either package loads in the other (float32, as both
    load): params, weights, f and the history equal, the data drawn again
    from the spec within the dataset bound of tests/test_torch_data.py;
  * a spec JSON written by `repro` loads in `repro_torch`, and back;
  * `fit(spec)` with no CUDA device raises instead of running on the CPU;
  * each spec field the port does not implement raises NotPortedError
    naming its ROADMAP item; the transport specs that used to (a lossy
    codec, a sparse topology, a byte budget), the rff and mlp families and
    the fault specs (a crash, drops) match repro.api.fit;
  * Minimax Protection through the api: fit, batch_fit and sweep over the
    grid {"solver.alpha": [1, 20], "solver.delta": [0, 0.01]} against
    repro.api on the same float64 arrays (1e-10, bytes equal), the eq. 28
    bound against repro's (1e-12), and the ledger equal to
    comm_floats_per_sweep x 8 for all three solvers;
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
    pytest.param(dict(backend=tapi.BackendSpec(name="shard_map", checks="raise")),
                 "A11b", id="change4-A11-checked"),
    pytest.param(dict(backend=tapi.BackendSpec(name="shard_map")), "A11b",
                 id="change5-A11"),
])
def test_unported_fields_raise_with_roadmap_item(change, item):
    """The shard_map backend validates and fits since A11a; its compiled
    Monte-Carlo loop is what still waits, for A11b (compiled=False runs
    serial fits)."""
    spec = tapi.ExperimentSpec(**change)
    spec.validate()
    with pytest.raises(tapi.NotPortedError, match=rf"ROADMAP {item}\b"):
        tapi.batch_fit(spec, 2, device="cpu")
    with pytest.raises(tapi.NotPortedError, match=rf"ROADMAP {item}\b"):
        tapi.batch_fit(spec, 2, device="cpu", compiled=True)


@pytest.mark.parametrize("change", [
    pytest.param({"agent": {"family": "rff"}}, id="rff"),
    pytest.param({"faults": {"crash": [[0, 1, 2]]}}, id="crash"),
    pytest.param({"faults": {"drop_rate": 0.1}}, id="drop"),
    pytest.param({"agent": {"family": "mlp", "options": [["hidden", 8],
                                                          ["fit_steps", 5]]}},
                 id="mlp"),
    pytest.param({"obs": {"taps": ["eta", "accepts"]}}, id="obs"),
])
def test_specs_once_unported_match_jax(change):
    """The agent families, fault specs and obs taps that raised
    NotPortedError before their slice (the rows that left the table above),
    from the spec in float64 against repro.api.fit: histories at 1e-10,
    bytes equal (the
    mlp family cut to hidden 8 and 5 Adam steps: at its defaults the JAX
    package's sweep takes minutes to compile here)."""
    d = {"data": {"n_train": 300, "n_test": 200, "seed": 3},
         "solver": {"n_sweeps": 3}, "seed": 2, **change}
    dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        tres = tapi.fit(tapi.spec_from_dict(d), device="cpu")
    finally:
        torch.set_default_dtype(dt)
    jres = _jax_fit(japi.spec_from_dict(d), True)
    _same_history(tres, jres)


@pytest.mark.parametrize("transport", [
    dict(codec="topk_sparse"), dict(topology="star"), dict(codec="int8_affine"),
    dict(topology="ring"), dict(byte_budget=1e6), dict(codec="exact_bf16"),
], ids=lambda t: "-".join(f"{k}={v}" for k, v in t.items()))
def test_transport_specs_once_unported_match_jax(transport):
    """The transport specs that raised NotPortedError before the transport
    layer was ported: fit from the spec, float64, against repro.api.fit
    (histories at 1e-10, bytes equal)."""
    d = {"data": {"n_train": 200, "n_test": 100, "seed": 1},
         "solver": {"n_sweeps": 2}, "transport": transport}
    dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        tres = tapi.fit(tapi.spec_from_dict(d), device="cpu")
    finally:
        torch.set_default_dtype(dt)
    jres = _jax_fit(japi.spec_from_dict(d), True)
    _same_history(tres, jres)


# ------------------------------------------------------- Minimax Protection

MM_GRID = {"solver.alpha": [1.0, 20.0], "solver.delta": [0.0, 0.01]}
MM_SOLVER = dict(n_sweeps=3, minimax_steps=60, eps=0.0)


def _mm_base(engine="incremental"):
    return tapi.ExperimentSpec(data=tapi.DataSpec(n_train=400, n_test=300, seed=2),
                               solver=tapi.SolverSpec(engine=engine, **MM_SOLVER),
                               seed=4)


def _jax_spec(tspec):
    """The same spec in the JAX package (the JSON layouts are one)."""
    return japi.spec_from_dict(json.loads(json.dumps(tapi.spec_to_dict(tspec))))


def _f64(data):
    return data._replace(**{k: getattr(data, k).double()
                            for k in ("xcols", "y", "xcols_test", "y_test")})


def _jax_result(tspec, tdata):
    """repro.api's run of `tspec` on the port's float64 data."""
    arrays = [a.cpu().numpy() for a in tdata[:4]]
    with jax.enable_x64(True):
        return run_solver(_jax_spec(tspec),
                          JDataset(*map(jnp.asarray, arrays), tdata.groups),
                          JPoly(n_cols=1, degree=4))


def _same_history(tres, jres, rtol=1e-10):
    for key in ("train_mse", "test_mse", "eta"):
        np.testing.assert_allclose(getattr(tres.history, key),
                                   getattr(jres.history, key), rtol=rtol,
                                   err_msg=key)
    assert tres.history.bytes_transmitted == jres.history.bytes_transmitted


@pytest.mark.parametrize("engine", ["dense", "incremental", "fused"])
def test_fit_minimax_grid_matches_jax(engine):
    """Every grid point through api.fit against repro.api.solvers.run_solver
    on the same float64 arrays; the eq. 28 bound of each against repro's."""
    base = _mm_base(engine)
    data = _f64(base.data.build("cpu"))
    for tspec in tapi.grid_specs(base, MM_GRID):
        tres = tapi.fit(tspec, device="cpu", data=data)
        jres = _jax_result(tspec, data)
        _same_history(tres, jres)
        np.testing.assert_allclose(tres.weights.numpy(), np.asarray(jres.weights),
                                   rtol=1e-9, atol=1e-12)
        with jax.enable_x64(True):
            want = jres.minimax_upper_bound()
            want_100 = jres.minimax_upper_bound(alpha=100.0)
        assert abs(tres.minimax_upper_bound() - want) <= 1e-12 * abs(want)
        assert abs(tres.minimax_upper_bound(alpha=100.0) - want_100) <= (
            1e-12 * abs(want_100))


def test_batch_fit_and_sweep_minimax_grid_match_jax():
    """batch_fit (2 trials) and sweep over the grid: each trial against
    repro.api on that trial's data and spec (seed + t: the same subsamples)."""
    dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        base = _mm_base("fused")
        rsets = tapi.sweep(base, MM_GRID, trials=2, device="cpu")
        singles = tapi.sweep(base, MM_GRID, device="cpu")
        assert len(rsets) == len(singles) == 4
        for rs, one in zip(rsets, singles):
            _same_history(one, _jax_result(one.spec, one.data))
            for t, res in enumerate(rs):
                tspec = tapi.trial_spec(rs.spec, t)
                _same_history(res, _jax_result(tspec, tspec.data.build("cpu")))
    finally:
        torch.set_default_dtype(dt)


def test_dense_engine_on_a_kernel_and_in_a_batch_raise():
    """The dense engine on a kernel raises (the reference has none, C6); in
    a batch it runs (the batched dense engine), trial t equal to
    fit(trial_spec(spec, t))."""
    spec = tapi.ExperimentSpec(data=tapi.DataSpec(n_train=100, n_test=50),
                               solver=tapi.SolverSpec(engine="dense",
                                                      use_kernel=True))
    with pytest.raises(ValueError, match="plain-PyTorch oracle"):
        tapi.fit(spec, device="cpu")
    batch = tapi.ExperimentSpec(data=tapi.DataSpec(n_train=100, n_test=50),
                                solver=tapi.SolverSpec(engine="dense",
                                                       n_sweeps=2, eps=0.0))
    rs = tapi.batch_fit(batch, 2, device="cpu")
    for t, res in enumerate(rs):
        one = tapi.fit(tapi.trial_spec(batch, t), device="cpu")
        np.testing.assert_allclose(res.history.eta, one.history.eta, rtol=1e-5)
        assert res.history.bytes_transmitted == one.history.bytes_transmitted


@pytest.mark.parametrize("solver", [
    dict(name="averaging"), dict(name="residual_refitting"),
    dict(engine="incremental"), dict(engine="fused"), dict(engine="dense"),
    dict(engine="dense", row_broadcast=True),
    dict(engine="incremental", alpha=20.0), dict(engine="fused", alpha=100.0),
    dict(engine="dense", alpha=20.0),
    dict(engine="dense", alpha=20.0, row_broadcast=True),
])
def test_comm_floats_equal_the_measured_ledger(solver):
    """comm_floats_per_sweep x 8 is every sweep's (or cycle's) measured
    bytes, for all three solvers, and repro's table says the same."""
    spec = tapi.ExperimentSpec(data=tapi.DataSpec(n_train=200, n_test=50),
                               solver=tapi.SolverSpec(n_sweeps=2, eps=0.0,
                                                      **solver))
    res = tapi.fit(spec, device="cpu")
    per = tapi.comm_floats_per_sweep(spec.solver, 5, 200) * 8
    assert per == japi.comm_floats_per_sweep(japi.SolverSpec(n_sweeps=2,
                                                             **solver), 5, 200) * 8
    got = res.history.bytes_transmitted
    if spec.solver.name == "icoa":
        assert got == [0.0] + [float(per)] * 2
    elif spec.solver.name == "averaging":
        assert got == [0.0] and per == 0
    else:
        assert got == [float(per)] * 2


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


# ------------------------------------------------- from the spec, both sides

FROM_SPEC = {
    "default": {},
    "cosine": dict(data=dict(source="cosine", n_attrs=6,
                             source_options=[["freq", 1.5]])),
    "correlated_blocks": dict(data=dict(source="correlated_linear", n_attrs=10,
                                        n_agents=5, partition="blocks")),
    "correlated_overlapping": dict(data=dict(
        source="correlated_linear", n_attrs=6, n_agents=3,
        partition="overlapping", partition_options=[["overlap", 1]],
        source_options=[["rho", 0.8]])),
    "friedman2_round_robin": dict(data=dict(source="friedman2", n_agents=5,
                                            partition="round_robin",
                                            noise=0.05)),
    "friedman3_random": dict(data=dict(source="friedman3", n_agents=5,
                                       partition="random",
                                       partition_options=[["seed", 3]])),
    "linear_family": dict(agent=dict(family="linear"),
                          solver=dict(engine="fused")),
    "rff_family": dict(agent=dict(family="rff"), solver=dict(engine="fused")),
}
# fp32: the kernel-path contract at alpha = 1 (test_torch_icoa.F32_TOL)
F32_TOL = 1e-5


def _from_spec_pair(case, **solver):
    d = json.loads(json.dumps(FROM_SPEC[case]))
    d.setdefault("data", {}).update(n_train=300, n_test=200, seed=3)
    d.setdefault("solver", {}).update(n_sweeps=3, **solver)
    d["seed"] = 2
    return tapi.spec_from_dict(d), japi.spec_from_dict(d)


def _jax_fit(jspec, x64):
    japi.clear_dataset_cache()
    try:
        with jax.enable_x64(x64):
            return japi.fit(jspec)
    finally:
        japi.clear_dataset_cache()


@pytest.mark.parametrize("case", list(FROM_SPEC))
def test_fit_from_spec_matches_jax_f64(case):
    tspec, jspec = _from_spec_pair(case)
    dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        tres = tapi.fit(tspec, device="cpu")
    finally:
        torch.set_default_dtype(dt)
    jres = _jax_fit(jspec, True)
    assert tres.f.dtype == torch.float64 and tres.data.groups == jres.data.groups
    if case == "linear_family":
        _within_reference_spread(tres, jres, jspec, True, 1e-10)
    else:
        _same_history(tres, jres)
    assert tres.history.converged_at == jres.history.converged_at
    np.testing.assert_allclose(tres.weights.numpy(), np.asarray(jres.weights),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tres.params.numpy(), np.asarray(jres.params),
                               rtol=1e-8, atol=1e-10)


def _within_reference_spread(tres, jres, jspec, x64, floor):
    """Each history within max(floor, 4x the JAX package's own spread): how
    far its records move, at most, when its data move by one ulp: all
    scaled by 1 + eps, or each value by a seeded 1 + k eps, k in
    {-1, 0, 1} (three draws; the port's data differ from the JAX
    package's in such element-wise last bits), with eps = 1e-15 in
    float64 and 2**-23 in float32; bytes equal.  Where the records are
    well conditioned the floor holds them; where the records amplify the
    data's last bits (linear agents on Friedman-1 combine with weights up
    to -2.5; float32 runs), the reference's own spread is the yardstick."""
    eps, dt = (1e-15, np.float64) if x64 else (2.0 ** -23, np.float32)
    data = [np.asarray(a) for a in jres.data[:4]]
    moves = [[a * dt(1 + eps) for a in data]]
    for seed in range(3):
        rng = np.random.default_rng(seed)
        moves.append([a * (1 + dt(eps) * rng.integers(-1, 2, a.shape).astype(dt))
                      for a in data])
    with jax.enable_x64(x64):
        perts = [run_solver(jspec, JDataset(*map(jnp.asarray, arrays),
                                            jres.data.groups), jres.family)
                 for arrays in moves]
    for key in ("train_mse", "test_mse", "eta"):
        want = np.asarray(getattr(jres.history, key))
        spread = max(np.max(np.abs(np.asarray(getattr(p.history, key)) - want)
                            / want) for p in perts)
        gap = np.max(np.abs(np.asarray(getattr(tres.history, key)) - want)
                     / want)
        print(f"\n{jspec.data.source} {jspec.agent.family} x64={x64} {key}: the "
              f"port's gap {gap:.3e}, the JAX package's one-ulp spread {spread:.3e}")
        assert spread > 0 and gap <= max(floor, 4 * spread), (key, gap, spread)
    assert tres.history.bytes_transmitted == jres.history.bytes_transmitted


@pytest.mark.parametrize("case", ["default", "cosine", "correlated_blocks",
                                  "linear_family", "rff_family"])
def test_fit_from_spec_matches_jax_f32(case):
    """float32 from the spec: the default and cosine runs within F32_TOL
    (their data equal the JAX package's bit for bit, the outcomes' float32
    sin / cos being the C library's, data.libm; what is left is the two
    solvers' float32 arithmetic); correlated_linear's covariates come
    from a Cholesky factor and a product that round differently in the two
    libraries (LAPACK's potrf, XLA's dot), and the linear agents amplify
    the last bits of either package's run (on the same data); the rff
    agents' features are bit for bit, but their ridge solve over 64
    features amplifies the Gram's summation order: those three are held
    to the JAX package's own one-ulp spread (ROADMAP P4)."""
    tspec, jspec = _from_spec_pair(case)
    tres = tapi.fit(tspec, device="cpu")
    jres = _jax_fit(jspec, False)
    assert tres.f.dtype == torch.float32
    if case in ("default", "cosine"):
        _same_history(tres, jres, rtol=F32_TOL)
    else:
        _within_reference_spread(tres, jres, jspec, False, F32_TOL)


def test_alpha100_deploy_width_blows_up_alike_f64():
    """The deployment width (correlated_linear, D = 100) at alpha = 100,
    one incremental sweep, N cut to 32768: seed 12 gives weights that blow
    up on the test split, as the card's deployment cell does at N = 262144
    (test MSE far above eta, sum |w| in the thousands).  Both packages,
    from the spec alone in float64, reach the same weights and records, so
    the blow-up is the configuration's and the data's, not the port's."""
    d = dict(data=dict(source="correlated_linear", n_attrs=100, n_train=32768,
                       n_test=8192, seed=12),
             solver=dict(engine="incremental", n_sweeps=1, alpha=100.0))
    dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        tres = tapi.fit(tapi.spec_from_dict(d), device="cpu")
    finally:
        torch.set_default_dtype(dt)
    jres = _jax_fit(japi.spec_from_dict(d), True)
    _same_history(tres, jres, rtol=1e-9)      # 1e-10 of the weights x sum |w|
    w, jw = tres.weights.numpy(), np.asarray(jres.weights)
    np.testing.assert_allclose(w, jw, rtol=1e-9, atol=1e-10 * np.abs(jw).max())
    assert np.abs(jw).sum() > 1000 and jres.history.test_mse[-1] > 1000 * jres.history.eta[-1]
    print(f"\nalpha=100 at D=100, N=32768, seed 12 (float64): the JAX package's "
          f"eta {jres.history.eta}, test MSE {jres.history.test_mse}, sum |w| "
          f"{np.abs(jw).sum()!r}; the port's test MSE {tres.history.test_mse}")


def _equal_results(got_params, got_weights, got_f, got_hist, want):
    np.testing.assert_array_equal(np.asarray(got_params), np.asarray(want.params))
    np.testing.assert_array_equal(np.asarray(got_weights), np.asarray(want.weights))
    np.testing.assert_array_equal(np.asarray(got_f), np.asarray(want.f))
    assert got_hist.as_dict() == want.history.as_dict()


@pytest.mark.parametrize("case", ["default", "correlated_blocks"])
def test_result_saved_by_port_loads_in_jax(tmp_path, case):
    tspec, _ = _from_spec_pair(case, engine="fused")
    tres = tapi.fit(tspec, device="cpu")
    tres.save(str(tmp_path))
    japi.clear_dataset_cache()
    jback = japi.load(str(tmp_path))
    assert jback.spec == japi.spec_from_dict(tapi.spec_to_dict(tspec))
    _equal_results(jback.params, jback.weights, jback.f, jback.history, tres)
    back = tapi.load(str(tmp_path), device="cpu")
    _equal_results(back.params, back.weights, back.f, back.history, tres)
    assert back.spec == tspec and back.family == tres.family
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (50, tspec.data.resolved_n_attrs)).astype(np.float32))
    assert torch.equal(back.predict(x), tres.predict(x))
    _data_close(back.data, jback.data)
    japi.clear_dataset_cache()


@pytest.mark.parametrize("case", ["default", "linear_family"])
def test_result_saved_by_jax_loads_in_port(tmp_path, case):
    _, jspec = _from_spec_pair(case)
    jres = _jax_fit(jspec, False)
    jres.save(str(tmp_path))
    back = tapi.load(str(tmp_path), device="cpu")
    assert tapi.spec_to_dict(back.spec) == japi.spec_to_dict(jspec)
    _equal_results(back.params, back.weights, back.f, back.history, jres)
    assert type(back.family).__name__ == type(jres.family).__name__
    _data_close(back.data, jres.data)
    assert tapi.load(str(tmp_path), with_data=False, device="cpu").data is None
    x = np.random.default_rng(1).standard_normal((50, 5)).astype(np.float32)
    np.testing.assert_allclose(back.predict(torch.from_numpy(x)).numpy(),
                               np.asarray(jres.predict(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


def _data_close(tdata, jdata, tol=2e-6):
    """The dataset bound of tests/test_torch_data.py (float32)."""
    for name in ("xcols", "y", "xcols_test", "y_test"):
        a = getattr(tdata, name).numpy()
        b = np.asarray(getattr(jdata, name))
        assert a.shape == b.shape and np.max(np.abs(a - b)) <= tol, name


def test_load_needs_a_card_unless_asked(tmp_path, monkeypatch):
    tres = tapi.fit(tapi.ExperimentSpec(data=tapi.DataSpec(n_train=50, n_test=20),
                                        solver=tapi.SolverSpec(n_sweeps=1)),
                    device="cpu")
    tres.save(str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.load(str(tmp_path))


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
    names = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for pkg in ("obs", "stream", "optim", "train"):   # the later slices' packages
        assert f"src/repro_torch/{pkg}/__init__.py" in names
    assert "src/repro_torch/launch/train.py" in names
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
        "import repro_torch.obs, repro_torch.stream\n"
        "s = api.stream_fit(api.StreamSpec(window=64, chunk=32, resweep_every=64,\n"
        "    total_instances=64), device='cpu')\n"
        "assert len(s.records) == 1\n"
        "from repro_torch.launch import train\n"
        "assert train.main(['--arch', 'rwkv6-1.6b', '--smoke', '--device', 'cpu',\n"
        "                   '--steps', '1', '--seq', '8', '--batch', '1']) == 0\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
        "print('ok', len(r.history.eta))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "ok 3"
