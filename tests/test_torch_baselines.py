"""The paper's two baselines (Table 1): repro_torch.core.baselines against
repro.core.baselines, and their solvers against repro.api's, float64, the
same numpy arrays on both sides:

  * averaging and residual_refitting (D=5 Friedman-1 agents, N=400): params,
    f and every record within 1e-12;
  * the batched forms (a leading trial axis, B=3) against the JAX package's
    averaging_scan / residual_refitting_scan under jax.vmap: 1e-12, and
    slice b equal to the single-trial run on trial b;
  * api.fit of each baseline against repro.api.solvers.run_solver: records
    at 1e-12, byte histories equal, weights equal; batch_fit trial t equal
    to fit(trial_spec(spec, t)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.agents import PolynomialFamily as JPoly
from repro.api.solvers import run_solver
from repro.api.specs import Dataset as JDataset
from repro.core import baselines as jbase
from repro.data.friedman import make_dataset
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.agents import PolynomialFamily as TPoly
from repro_torch.core import baselines as tbase

B, D, N = 3, 5, 400
RTOL = 1e-12


@pytest.fixture(autouse=True)
def x64():
    with jax.enable_x64(True):
        yield


def _trial(seed, n=N):
    xtr, ytr, xte, yte = make_dataset(1, n_train=n, n_test=n, seed=seed)
    return [np.asarray(a, np.float64) for a in (np.asarray(xtr).T[:, :, None], ytr,
                                                np.asarray(xte).T[:, :, None], yte)]


def _close(got, want, rtol=RTOL, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.max(np.abs(want)), 1e-300),
                               err_msg=what)


def test_averaging_matches_jax():
    arrays = _trial(0)
    jp, jout = jbase.averaging(JPoly(1, 4), *map(jnp.asarray, arrays))
    tp, tf, th = tbase.averaging(TPoly(1, 4), *map(torch.from_numpy, arrays))
    _close(tp, jp, what="params")
    _close(tf, jax.vmap(JPoly(1, 4).predict)(jp, jnp.asarray(arrays[0])), what="f")
    for key in ("train_mse", "test_mse"):
        assert abs(th[key] - jout[key]) <= RTOL * abs(jout[key]), key


@pytest.mark.parametrize("n_cycles", [1, 4])
def test_residual_refitting_matches_jax(n_cycles):
    arrays = _trial(1)
    jp, jf, jh = jbase.residual_refitting(JPoly(1, 4), *map(jnp.asarray, arrays),
                                          n_cycles=n_cycles)
    tp, tf, th = tbase.residual_refitting(TPoly(1, 4),
                                          *map(torch.from_numpy, arrays),
                                          n_cycles=n_cycles)
    _close(tp, jnp.stack(jp), what="params")
    _close(tf, jf, what="f")
    for key in ("train_mse", "test_mse", "eta"):
        assert len(th[key]) == n_cycles
        _close(np.asarray(th[key]), np.asarray(jh[key]), what=key)


def _batch():
    trials = [_trial(t) for t in range(B)]
    return [np.stack([t[k] for t in trials]) for k in range(4)]


def test_batched_baselines_match_jax_scans():
    arrays = _batch()
    jarr = list(map(jnp.asarray, arrays))
    tarr = convert.batch_from_numpy(*arrays)
    fam_j, fam_t = JPoly(1, 4), TPoly(1, 4)
    jp, jf, jh = jax.vmap(lambda x, y, xt, yt, s: jbase.averaging_scan(
        fam_j, x, y, xt, yt, s))(*jarr, jnp.arange(B))
    tp, tf, th = tbase.averaging(fam_t, *tarr)
    _close(tp, jp, what="averaging params")
    _close(tf, jf, what="averaging f")
    for key in ("train_mse", "test_mse", "eta"):
        _close(th[key], jh[key][:, 0], what=f"averaging {key}")
    jp, jf, jh = jax.vmap(lambda x, y, xt, yt, s: jbase.residual_refitting_scan(
        fam_j, x, y, xt, yt, 3, s))(*jarr, jnp.arange(B))
    tp, tf, th = tbase.residual_refitting(fam_t, *tarr, n_cycles=3)
    _close(tp, jp, what="refit params")
    _close(tf, jf, what="refit f")
    for key in ("train_mse", "test_mse", "eta"):
        assert th[key].shape == (B, 3)
        _close(th[key], jh[key], what=f"refit {key}")
    for b in range(B):
        one = tbase.residual_refitting(fam_t, *(a[b] for a in tarr), n_cycles=3)
        _close(tf[b], one[1].numpy(), rtol=1e-13, what=f"slice {b}")


def _spec(name, **kw):
    solver = dict(name=name, n_sweeps=3, **kw)
    data = dict(n_train=N, n_test=300)
    return (japi.ExperimentSpec(data=japi.DataSpec(**data),
                                solver=japi.SolverSpec(**solver)),
            tapi.ExperimentSpec(data=tapi.DataSpec(**data),
                                solver=tapi.SolverSpec(**solver)))


@pytest.mark.parametrize("name", ["averaging", "residual_refitting"])
def test_fit_matches_jax_run_solver(name):
    jspec, tspec = _spec(name)
    tdata = tspec.data.build("cpu")
    tdata = tdata._replace(xcols=tdata.xcols.double(), y=tdata.y.double(),
                           xcols_test=tdata.xcols_test.double(),
                           y_test=tdata.y_test.double())
    arrays = [a.numpy() for a in tdata[:4]]
    jres = run_solver(jspec, JDataset(*map(jnp.asarray, arrays), tdata.groups),
                      JPoly(n_cols=1, degree=4))
    tres = tapi.fit(tspec, device="cpu", data=tdata)
    for key in ("train_mse", "test_mse", "eta"):
        _close(np.asarray(getattr(tres.history, key)),
               np.asarray(getattr(jres.history, key)), what=key)
    assert tres.history.bytes_transmitted == jres.history.bytes_transmitted
    assert tres.history.converged_at == jres.history.converged_at
    _close(tres.weights, jres.weights, what="weights")
    _close(tres.f, jres.f, what="f")
    per = tapi.comm_floats_per_sweep(tspec.solver, D, N) * 8
    assert tres.history.bytes_transmitted == (
        [0.0] if name == "averaging" else [float(per)] * 3)


@pytest.mark.parametrize("name", ["averaging", "residual_refitting"])
def test_batch_fit_trial_equals_fit(name):
    dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        _, tspec = _spec(name)
        rs = tapi.batch_fit(tspec, B, device="cpu")
        for t, res in enumerate(rs):
            one = tapi.fit(tapi.trial_spec(tspec, t), device="cpu")
            for key in ("train_mse", "test_mse", "eta"):
                np.testing.assert_allclose(getattr(res.history, key),
                                           getattr(one.history, key), rtol=1e-10)
            assert res.history.bytes_transmitted == one.history.bytes_transmitted
            assert res.history.converged_at is None
            _close(res.weights, one.weights.numpy(), what="weights")
    finally:
        torch.set_default_dtype(dt)
