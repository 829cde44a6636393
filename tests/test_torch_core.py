"""repro_torch core, transport, agents and data against their JAX twins.

Every function of the slice's core modules gets the same numpy inputs on
both sides, in float64 (JAX under `jax.enable_x64`), and must agree at
1e-12 relative: ensemble, covariance, gradient, covstate (build, the probes,
the commits), the polynomial family and the fused engine's projector.  The
transport layer's topology, codec and ledger prices must agree exactly.
The port's data generators draw from torch.Generator, not threefry, so
they are checked for their contract (shapes, seeding, standardisation),
not against the JAX package's samples.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.agents import PolynomialFamily as JPoly
from repro.core import covariance as jcov
from repro.core import covstate as jcs
from repro.core import ensemble as jens
from repro.core import gradient as jgrad
from repro.core import icoa as jicoa
from repro import transport as jtransport
from repro_torch import prng
from repro_torch.agents import PolynomialFamily as TPoly
from repro_torch.core import covariance as tcov
from repro_torch.core import covstate as tcs
from repro_torch.core import ensemble as tens
from repro_torch.core import gradient as tgrad
from repro_torch.core import icoa as ticoa
from repro_torch import transport as ttransport
from repro_torch.data import sources as tsources
from repro_torch.data import friedman as tfriedman

RTOL = 1e-12


@pytest.fixture(autouse=True)
def x64():
    with jax.enable_x64(True):
        yield


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _residuals(d=6, n=400, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(n)
    return base[None, :] + 0.5 * rng.standard_normal((d, n))


# ----------------------------------------------------------------- ensemble


def test_ensemble_matches_jax():
    r = _residuals()
    a = r @ r.T / r.shape[1]
    ta, ja = torch.from_numpy(a), jnp.asarray(a)
    _close(tens.solve_vec(ta), jens.solve_vec(ja))
    _close(tens.optimal_weights(ta), jens.optimal_weights(ja))
    _close(tens.eta_tilde(ta), jens.eta_tilde(ja))
    _close(tens.eta(ta), jens.eta(ja))
    w, f = np.linspace(0.1, 0.3, 6), r
    _close(tens.combine(torch.from_numpy(w), torch.from_numpy(f)),
           jens.combine(jnp.asarray(w), jnp.asarray(f)))
    assert tens._JITTER == jens._JITTER


# --------------------------------------------------------------- covariance


def test_covariance_matches_jax():
    r = _residuals(5, 333, seed=1)
    tr, jr = torch.from_numpy(r), jnp.asarray(r)
    _close(tcov.gram(tr), jcov.gram(jr))
    _close(tcov.residual_covariance(tr), jcov.residual_covariance(jr))
    _close(tcov.subsampled_gram(tr, None), jcov.subsampled_gram(jr, None))
    for n, alpha in [(2000, 1.0), (2000, 7.0), (10, 100.0), (600, 3.5)]:
        assert tcov.subsample_size(n, alpha) == jcov.subsample_size(n, alpha)
    # a subsample idx now splices the exact diagonal into its Gram
    idx = np.random.default_rng(1).permutation(333)[:40]
    _close(tcov.subsampled_gram(tr, torch.from_numpy(idx)),
           jcov.subsampled_gram(jr, jnp.asarray(idx)))


@pytest.mark.parametrize("alpha", [3.5, 20.0, 100.0])
def test_subsampled_covariance_matches_jax(alpha):
    """From the same key: the same subsample, the same A0; a key per trial
    gives each trial its own."""
    r = _residuals(5, 600, seed=21)
    jkey, tkey = jax.random.PRNGKey(11), prng.PRNGKey(11)
    got = tcov.subsampled_covariance(tkey, torch.from_numpy(r), alpha)
    _close(got, jcov.subsampled_covariance(jkey, jnp.asarray(r), alpha))
    sub = tcov.take_cols(torch.from_numpy(r), tcov.subsample_indices(tkey, 600, alpha))
    _close(tcov.spliced_gram(sub, torch.from_numpy((r * r).sum(1) / 600)),
           jcov.spliced_gram(jnp.asarray(r)[:, jcov.subsample_indices(jkey, 600, alpha)],
                             jnp.asarray((r * r).sum(1) / 600)))
    rb = np.stack([r, _residuals(5, 600, seed=22)])
    keys = prng.PRNGKey([11, 12])
    both = tcov.subsampled_covariance(keys, torch.from_numpy(rb), alpha)
    assert both.shape == (2, 5, 5)
    _close(both[0], got)
    _close(both[1], jcov.subsampled_covariance(jax.random.PRNGKey(12),
                                                jnp.asarray(rb[1]), alpha))


def test_covariance_kernel_path_is_fp32_cast_back():
    """use_kernel: fp32 products (the kernel contract), result in the
    residual dtype — as the JAX package's kernel path."""
    r = _residuals(4, 250, seed=2)
    got = tcov.gram(torch.from_numpy(r), use_kernel=True)
    assert got.dtype == torch.float64
    _close(got, jcov.gram(jnp.asarray(r), use_kernel=True), rtol=1e-6)


# ----------------------------------------------------------------- gradient


@pytest.mark.parametrize("exclude_self", [False, True])
def test_cached_row_gradient_matches_jax(exclude_self):
    r = _residuals(6, 300, seed=3)
    v = np.linspace(-1.0, 2.0, 6)
    _close(tgrad.cached_row_gradient(torch.from_numpy(v), torch.from_numpy(r), 2,
                                     exclude_self=exclude_self),
           jgrad.cached_row_gradient(jnp.asarray(v), jnp.asarray(r), 2,
                                     exclude_self=exclude_self))


# ----------------------------------------------------------------- covstate


def _states(seed=4):
    r = _residuals(7, 500, seed=seed)
    return tcs.build(torch.from_numpy(r)), jcs.build(jnp.asarray(r)), r


def test_covstate_build_and_refresh_match_jax():
    ts, js, _ = _states()
    for name in ("r_sub", "a0", "m_inv", "s", "eta_tilde"):
        _close(getattr(ts, name), getattr(js, name))
    assert torch.equal(ts.m_inv, ts.m_inv.T)
    assert ts.m_inv.is_contiguous()       # the sweep kernels read it row-major
    tr, jr = tcs.refresh(ts), jcs.refresh(js)
    _close(tr.m_inv, jr.m_inv)
    _close(tr.eta_tilde, jr.eta_tilde)


def test_covstate_probes_match_jax():
    ts, js, r = _states(5)
    rng = np.random.default_rng(9)
    u = 0.01 * rng.standard_normal(7)
    vec = rng.standard_normal(500)
    _close(tcs.row_product(torch.from_numpy(vec), ts.r_sub),
           jcs.row_product(jnp.asarray(vec), js.r_sub))
    _close(tcs.eta_probe(ts, 3, torch.from_numpy(u)),
           jcs.eta_probe(js, 3, jnp.asarray(u)))
    _close(tcs.s_probe(ts, 3, torch.from_numpy(u)),
           jcs.s_probe(js, 3, jnp.asarray(u)))
    # a batch of probes is the probes one by one (the back-search schedule)
    us = 0.01 * rng.standard_normal((4, 7))
    batch = tcs.eta_probe(ts, 1, torch.from_numpy(us))
    for k in range(4):
        _close(batch[k], jcs.eta_probe(js, 1, jnp.asarray(us[k])))


def test_covstate_commit_matches_jax():
    ts, js, r = _states(6)
    rng = np.random.default_rng(10)
    r_new = r[2] + 0.05 * rng.standard_normal(500)
    tu = tcs.row_update_vector(ts, 2, torch.from_numpy(r_new) - ts.r_sub[2])
    ju = jcs.row_update_vector(js, 2, jnp.asarray(r_new) - js.r_sub[2])
    _close(tu, ju)
    for got, want in zip(tcs.apply_inverse_update(ts, 2, tu),
                         jcs.apply_inverse_update(js, 2, ju)):
        _close(got, want)
    tn = tcs.apply_row_update(ts, 2, torch.from_numpy(r_new), tu)
    jn = jcs.apply_row_update(js, 2, jnp.asarray(r_new), ju)
    for name in ("r_sub", "a0", "m_inv", "s", "eta_tilde"):
        _close(getattr(tn, name), getattr(jn, name))
    assert torch.equal(ts.r_sub[2], torch.from_numpy(r[2]))   # input untouched
    # the committed state is the state rebuilt from the new residuals
    rebuilt = tcs.build(tn.r_sub)
    _close(tn.eta_tilde, rebuilt.eta_tilde, rtol=1e-9)


def _split_states(seed=7, alpha=20.0, batch=False):
    """(port state, JAX state, full residuals, idx) of the Sec 4.1 split: the
    subsample rows with the exact diagonal spliced in."""
    r = _residuals(6, 600, seed=seed)
    idx = np.asarray(jcov.subsample_indices(jax.random.PRNGKey(seed), 600, alpha))
    diag = (r * r).sum(1) / 600
    js = jcs.build(jnp.asarray(r[:, idx]), exact_diag=jnp.asarray(diag))
    ts = tcs.build(torch.from_numpy(r[:, idx]), exact_diag=torch.from_numpy(diag))
    return ts, js, r, idx


def test_covstate_split_build_and_update_match_jax():
    ts, js, r, idx = _split_states()
    for name in ("r_sub", "a0", "m_inv", "s", "eta_tilde"):
        _close(getattr(ts, name), getattr(js, name))
    _close(torch.diagonal(ts.a0), (r * r).sum(1) / 600)
    rng = np.random.default_rng(8)
    r_new = r[4] + 0.05 * rng.standard_normal(600)
    ddiag = float(r_new @ r_new / 600 - np.asarray(js.a0)[4, 4])
    delta = r_new[idx] - r[4, idx]
    tu = tcs.row_update_vector(ts, 4, torch.from_numpy(delta),
                               ddiag=torch.tensor(ddiag, dtype=torch.float64))
    ju = jcs.row_update_vector(js, 4, jnp.asarray(delta), ddiag=jnp.asarray(ddiag))
    _close(tu, ju)
    assert float(tu[4]) == 0.5 * ddiag
    tn = tcs.apply_row_update(ts, 4, torch.from_numpy(r_new[idx]), tu)
    jn = jcs.apply_row_update(js, 4, jnp.asarray(r_new[idx]), ju)
    for name in ("a0", "m_inv", "s", "eta_tilde"):
        _close(getattr(tn, name), getattr(jn, name))


@pytest.mark.parametrize("delta", [0.01, 0.2])
def test_robust_eta_probe_matches_jax(delta):
    """Single probes, a schedule of K probes in one call, and the same on a
    batched state of B trials: each the JAX package's probe one by one."""
    ts, js, _, _ = _split_states(seed=9)
    rng = np.random.default_rng(10)
    us = 0.01 * rng.standard_normal((4, 6))
    want = [float(jcs.robust_eta_probe(js, 2, jnp.asarray(u), delta, 80, 0.05))
            for u in us]
    _close(tcs.robust_eta_probe(ts, 2, torch.from_numpy(us[0]), delta, 80, 0.05),
           want[0])
    _close(tcs.robust_eta_probe(ts, 2, torch.from_numpy(us), delta, 80, 0.05),
           np.asarray(want))
    _close(tcs.s_probe(ts, 2, torch.from_numpy(us)),
           np.stack([np.asarray(jcs.s_probe(js, 2, jnp.asarray(u))) for u in us]))
    ts2, js2, _, _ = _split_states(seed=12)
    batched = tcs.CovState(*(torch.stack([a, b]) for a, b in zip(ts, ts2)))
    ub = torch.from_numpy(np.stack([us, 0.5 * us]))
    got = tcs.robust_eta_probe(batched, 2, ub, delta, 80, 0.05)
    assert got.shape == (2, 4)
    _close(got[0], np.asarray(want))
    _close(got[1], np.asarray([float(jcs.robust_eta_probe(
        js2, 2, jnp.asarray(0.5 * u), delta, 80, 0.05)) for u in us]))
    one = tcs.robust_eta_probe(batched, 2, ub[:, 1], delta, 80, 0.05)
    _close(one, got[:, 1])


# ------------------------------------------------------ autodiff gradients


def test_autodiff_gradients_match_jax_and_closed_form():
    rng = np.random.default_rng(15)
    y = rng.standard_normal(200)
    f = y[None, :] + 0.3 * rng.standard_normal((5, 200))
    tf_, ty = torch.from_numpy(f), torch.from_numpy(y)
    jf, jy = jnp.asarray(f), jnp.asarray(y)
    for i in (0, 3):
        _close(tgrad.agent_gradient(tf_, ty, i), jgrad.agent_gradient(jf, jy, i))
    every = tgrad.all_agent_gradients(tf_, ty)
    _close(every, jgrad.all_agent_gradients(jf, jy))
    _close(tgrad.closed_form_gradient(tf_, ty), jgrad.closed_form_gradient(jf, jy))
    _close(every, tgrad.closed_form_gradient(tf_, ty), rtol=1e-8)
    assert not tf_.requires_grad


# ------------------------------------------------- agents and the projector


def _cols(d=5, n=300, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((d, n, 1))
    return x, np.sin(x[..., 0].sum(0)) + 0.1 * rng.standard_normal(n)


def test_polynomial_family_matches_jax():
    x, y = _cols()
    tf, jf = TPoly(n_cols=1, degree=4), JPoly(n_cols=1, degree=4)
    for i in range(x.shape[0]):
        tp = tf.fit(None, torch.from_numpy(x[i]), torch.from_numpy(y))
        jp = jf.fit(jf.init(None), jnp.asarray(x[i]), jnp.asarray(y))
        _close(tp, jp, rtol=1e-10)
        _close(tf.predict(tp, torch.from_numpy(x[i])),
               jf.predict(jp, jnp.asarray(x[i])), rtol=1e-10)
    # the batched form is the per-agent form, agent by agent
    ys = np.ascontiguousarray(np.broadcast_to(y, x.shape[:2]))
    tb = tf.fit(None, torch.from_numpy(x), torch.from_numpy(ys))
    _close(tb[3], tf.fit(None, torch.from_numpy(x[3]), torch.from_numpy(y)))
    assert tf.n_features == jf.n_features == 5


def test_poly_projector_matches_jax():
    x, _ = _cols(4, 250, seed=12)
    tphi, tginv = ticoa._poly_projector(torch.from_numpy(x), 4, 1e-6)
    jphi, jginv = jicoa._poly_projector(jnp.asarray(x), 4, 1e-6)
    _close(tphi, jphi)
    _close(tginv, jginv, rtol=1e-10)
    for p in (1, 2):
        gm = np.eye(p) * 2.0 + 0.1
        _close(ticoa._small_inv(torch.from_numpy(gm)), np.linalg.inv(gm))


def test_init_state_matches_jax():
    x, y = _cols(5, 300, seed=13)
    ts = ticoa.init_state(TPoly(1, 4), torch.from_numpy(x), torch.from_numpy(y))
    keys = jax.random.split(jax.random.PRNGKey(0), 5)
    js = jicoa.init_state(JPoly(1, 4), keys, jnp.asarray(x), jnp.asarray(y))
    _close(ts.params, js.params, rtol=1e-10)
    _close(ts.f, js.f, rtol=1e-10)


# ---------------------------------------------------------------- transport


@pytest.mark.parametrize("d", [1, 2, 5, 100])
def test_transport_prices_match_jax(d):
    tt, jt = ttransport.default_transport(d), jtransport.default_transport(d)
    for name in ("adjacency", "hops", "ecc", "bcast_tx"):
        assert getattr(tt.topology, name) == getattr(jt.topology, name)
    for m in (1, 600, 262144):
        assert ttransport.gather_cost(tt, m, False) == jtransport.gather_cost(jt, m, False)
        for row_wise in (False, True):
            assert (ttransport.icoa_sweep_cost(tt, m, False, row_wise)
                    == jtransport.icoa_sweep_cost(jt, m, False, row_wise))
        for i in range(d):
            assert (ttransport.agent_broadcast_cost(tt, i, m, True)
                    == jtransport.agent_broadcast_cost(jt, i, m, True))
        for row_wise in (False, True):        # the Sec 4.1 split payload
            assert (ttransport.icoa_sweep_cost(tt, m, True, row_wise)
                    == jtransport.icoa_sweep_cost(jt, m, True, row_wise))
        assert (ttransport.refit_cycle_bytes(tt, d, m)
                == jtransport.refit_cycle_bytes(jt, d, m))


def test_exact_codecs_match_jax():
    x = np.random.default_rng(14).standard_normal((3, 40))
    for name in ("exact_f64", "exact_f32"):
        tc, jc = ttransport.build_codec(name), jtransport.build_codec(name)
        assert tc.nbytes(123) == jc.nbytes(123)
        for tdt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
            assert tc.is_identity_for(tdt) == jc.is_identity_for(jdt)
        _close(tc.roundtrip(torch.from_numpy(x)), jc.roundtrip(jnp.asarray(x)),
               rtol=0.0)
    tp = ttransport.Transport(topology=ttransport.build_topology("full", 3),
                              codec=ttransport.build_codec("exact_f32"))
    got = tp.relay_rows(torch.from_numpy(x))
    assert torch.equal(got, torch.from_numpy(x).float().double())
    row = torch.from_numpy(x[1])
    assert torch.equal(tp.relay_row(row, 1), row.float().double())
    assert torch.equal(tp.relay_scalar(row[0], 1), row[:1].float().double()[0])
    _close(tp.relay_scalars(torch.from_numpy(x[:, 0])),
           np.asarray(x[:, 0], np.float32).astype(np.float64), rtol=0.0)
    _close(tp.relay_scalars(torch.from_numpy(x[:2, :3])),        # per trial
           np.asarray(x[:2, :3], np.float32).astype(np.float64), rtol=0.0)
    xg = torch.from_numpy(x).requires_grad_(True)               # straight through
    (tp.relay_rows_st(xg) * 3.0).sum().backward()
    assert torch.equal(xg.grad, torch.full_like(xg, 3.0))
    xt = torch.from_numpy(x)
    assert ttransport.default_transport(3).relay_rows(xt) is xt   # identity
    assert ttransport.default_transport(3).relay_rows_st(xt) is xt
    with pytest.raises(ttransport.TransportError):
        ttransport.build_topology("hypercube", 3)


# --------------------------------------------------------------------- data


@pytest.mark.parametrize("source,n_attrs", [("friedman1", None), ("friedman2", None),
                                            ("friedman3", None),
                                            ("correlated_linear", 12)])
def test_sources_contract(source, n_attrs):
    xtr, ytr, xte, yte = tsources.make_dataset(source, 300, 100, seed=3,
                                               n_attrs=n_attrs)
    m = n_attrs or 5
    assert xtr.shape == (300, m) and xte.shape == (100, m)
    assert ytr.shape == (300,) and yte.shape == (100,)
    assert float(ytr.min()) == 0.0 and float(ytr.max()) == 1.0
    np.testing.assert_allclose(xtr.mean(0).numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(xtr.std(0, correction=0).numpy(), 1.0, atol=1e-5)
    again = tsources.make_dataset(source, 300, 100, seed=3, n_attrs=n_attrs)
    assert all(torch.equal(a, b) for a, b in zip((xtr, ytr, xte, yte), again))
    other = tsources.make_dataset(source, 300, 100, seed=4, n_attrs=n_attrs)
    assert not torch.equal(xtr, other[0])


def test_friedman1_formula():
    x, y = tfriedman.friedman1(prng.PRNGKey(0), 1000)
    x = x.numpy().astype(np.float64)
    raw = (10 * np.sin(np.pi * x[:, 0] * x[:, 1]) + 20 * (x[:, 2] - 0.5) ** 2
           + 10 * x[:, 3] + 5 * x[:, 4])
    want = (raw - raw.min()) / (raw.max() - raw.min())
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-6)
    assert 0.0 <= float(x.min()) and float(x.max()) <= 1.0
