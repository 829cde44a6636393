"""repro_torch's compiled Monte Carlo against repro's: the batched kernels'
plain versions, the batched run_scan, batch_fit, ResultSet and the grids.

Inputs are made with numpy from a seed and handed to both packages.
Small sizes throughout: D=5 agents, N in {160, 400}, B=3 trials, 2-3 sweeps.

  * batched plain versions vs the JAX batched Pallas kernels in interpret
    mode, reached as the JAX package reaches them — `jax.vmap` over the
    single-trial op, whose custom_vmap rule sends the batch to the
    `*_batched` kernel: fp32, normwise 1e-4 (max |torch - jax| <= 1e-4 *
    max |jax|, since entries of a product may sit near zero);
  * the native-dtype sweep plain versions vs the JAX refs under vmap in
    float64: 1e-12;
  * slice b of each batched plain version vs the single-trial plain version
    on trial b: fp32, normwise 1e-5 (a batched product may sum in another
    order than a single one);
  * port `run_scan` on convert.batch_from_numpy arrays vs
    `jax.vmap(repro.core.icoa.run_scan)` on the same arrays: float64 without
    kernels 1e-10; the kernel path (JAX Pallas interpret vs the port's plain
    versions, both fp32 products) in float64 data 1e-5; float32 data 3e-5 —
    on these inputs the JAX package's own serial `run` and its vmapped
    run_scan already differ by up to 1.04e-5 relative in float32 (the
    near-singular late-run covariance amplifies fp32 sum-order noise), so
    1e-5 would hold the port to less than the reference's own spread;
    `converged_at` equal;
  * batch_fit trial t vs fit(trial_spec(spec, t)) on the CPU: float64
    1e-10, float32 1e-4 (the fp32 contract of the card checks);
  * the batched dense engine: port `run_scan(engine="dense")` vs
    `jax.vmap(repro.core.icoa.run_scan)` in float64 at 1e-10 over
    (alpha, delta) in {(1, 0), (20, 0), (1, 0.02), (20, 0.01)}, with
    row_broadcast off and on, and each trial's slice vs the port's
    single-trial dense `run` on that trial at 1e-10;
  * batch_fit of the dense engine and of the cosine source (once raised
    as not ported): trial t vs fit(trial_spec(spec, t)), float64 1e-10;
  * ResultSet aggregates vs the JAX ResultSet over the same histories, the
    grid enumerations, and the NotPortedError of what waits for later items.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.agents import PolynomialFamily as JPoly
from repro.api.result import History as JHistory
from repro.api.result import Result as JResult
from repro.api.result import ResultSet as JResultSet
from repro.core import icoa as jicoa
from repro.data.friedman import make_dataset
from repro.kernels.gram import ops as jgram_ops
from repro.kernels.sweep import ops as jsweep_ops
from repro.kernels.sweep import ref as jsweep_ref
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.agents import PolynomialFamily as TPoly
from repro_torch.core import icoa as ticoa
from repro_torch.kernels import _build
from repro_torch.kernels.gram import ops as gram_ops
from repro_torch.kernels.gram import ref as gram_ref
from repro_torch.kernels.sweep import ops as sweep_ops
from repro_torch.kernels.sweep import ref as sweep_ref

B, D = 3, 5
KEYS = ("train_mse", "test_mse", "eta")
ENGINES = ("incremental", "fused")
BATCHED_KEYS = ("gram_batched", "row_gram_batched", "probe_sweep_batched",
                "commit_sweep_batched")


def _scenes(n, seed=0, dtype=np.float32, d=D, b=B):
    """B independent (residual rows, SPD m_inv, s = m_inv 1, eta = sum s,
    row delta, vector v) scenes stacked on a leading trial axis, and one
    K=16 step schedule, all numpy."""
    rng = np.random.default_rng(seed)
    out = {k: [] for k in ("r", "m_inv", "s", "eta", "delta", "v")}
    for _ in range(b):
        m = rng.standard_normal((d, 2 * d))
        m_inv = m @ m.T / (2 * d) + np.eye(d)
        m_inv = 0.5 * (m_inv + m_inv.T)
        s = m_inv.sum(axis=1)
        for k, a in (("r", rng.standard_normal((d, n))), ("m_inv", m_inv),
                     ("s", s), ("eta", s.sum()),
                     ("delta", 0.05 * rng.standard_normal(n)),
                     ("v", rng.standard_normal(n))):
            out[k].append(a)
    sc = {k: np.asarray(np.stack(v), dtype) for k, v in out.items()}
    sc["steps"] = np.asarray(math.sqrt(n) * 0.5 ** np.arange(16), dtype)
    return sc


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.max(np.abs(want)), 1e-30)
    err = np.max(np.abs(got - want))
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


# ----------------------------------------------- batched kernels, plain versions


@pytest.mark.parametrize("n", [160, 400])
def test_gram_batched_plain_matches_jax_vmap(n):
    sc = _scenes(n)
    got = gram_ops.gram(_t(sc["r"]))
    assert got.shape == (B, D, D) and got.dtype == torch.float32
    want = jax.vmap(lambda r: jgram_ops.gram(r, use_pallas=True,
                                             interpret=True))(jnp.asarray(sc["r"]))
    _close(got.numpy(), want, 1e-4, "gram")
    for b in range(B):
        _close(got[b].numpy(), gram_ref.gram_ref(_t(sc["r"][b])).numpy(), 1e-5,
               f"gram slice {b}")


@pytest.mark.parametrize("shared_v", [False, True])
@pytest.mark.parametrize("n", [160, 400])
def test_row_gram_batched_plain_matches_jax_vmap(n, shared_v):
    """A v shared by every trial is broadcast (the JAX rule's unbatched
    operand)."""
    sc = _scenes(n)
    r = jnp.asarray(sc["r"])
    if shared_v:
        v = sc["v"][0]
        want = jax.vmap(lambda rr: jgram_ops.row_gram(
            jnp.asarray(v), rr, use_pallas=True, interpret=True))(r)
    else:
        v = sc["v"]
        want = jax.vmap(lambda vv, rr: jgram_ops.row_gram(
            vv, rr, use_pallas=True, interpret=True))(jnp.asarray(v), r)
    got = gram_ops.row_gram(_t(v), _t(sc["r"]))
    assert got.shape == (B, D)
    _close(got.numpy(), want, 1e-4, "row_gram")
    for b in range(B):
        vb = v if shared_v else v[b]
        _close(got[b].numpy(),
               gram_ref.row_gram_ref(_t(vb), _t(sc["r"][b])).numpy(), 1e-5,
               f"row_gram slice {b}")


def _probe_args(sc, torch_side=True):
    conv = _t if torch_side else jnp.asarray
    return [conv(sc[k]) for k in ("r", "m_inv", "s", "eta")]


@pytest.mark.parametrize("n", [160, 400])
def test_probe_sweep_batched_plain_matches_jax_vmap(n):
    sc = _scenes(n, seed=n)
    i = 2
    got = sweep_ops.probe_sweep(*_probe_args(sc), i, _t(sc["steps"]))
    steps = jnp.asarray(sc["steps"])
    want = jax.vmap(lambda r, m, s, e: jsweep_ops.probe_sweep(
        r, m, s, e, i, steps, use_pallas=True, interpret=True))(
            *_probe_args(sc, torch_side=False))
    names = ("etas", "cross", "p", "gnorm")
    for name, g, w in zip(names, got, want):
        _close(g.numpy(), w, 1e-4, name)
    for b in range(B):
        single = sweep_ops.probe_sweep(*[a[b] for a in _probe_args(sc)], i,
                                       _t(sc["steps"]))
        for name, g, w in zip(names, got, single):
            _close(g[b].numpy(), w.numpy(), 1e-5, f"probe slice {b} {name}")


@pytest.mark.parametrize("n", [160, 400])
def test_commit_sweep_batched_plain_matches_jax_vmap(n):
    """Mixed accept and reject in one batch: trial 1 is rejected (threshold
    +inf) and keeps its m_inv and s bitwise while trials 0 and 2 commit."""
    sc = _scenes(n, seed=n + 1)
    i = 3
    thr = np.asarray([-np.inf, np.inf, -np.inf], np.float32)
    got = sweep_ops.commit_sweep(*_probe_args(sc), i, _t(sc["delta"]), 1.0,
                                 0.0, _t(thr), True)
    want = jax.vmap(lambda r, m, s, e, dl, th: jsweep_ops.commit_sweep(
        r, m, s, e, i, dl, 1.0, 0.0, th, 1.0, use_pallas=True,
        interpret=True))(*_probe_args(sc, torch_side=False),
                         jnp.asarray(sc["delta"]), jnp.asarray(thr))
    assert got[3].tolist() == [True, False, True]
    assert np.asarray(want[3]).tolist() == [True, False, True]
    for name, k in (("m_inv", 0), ("s", 1), ("u_eff", 2), ("obj_post", 4)):
        _close(got[k].numpy(), want[k], 1e-4, name)
    assert torch.equal(got[0][1], _t(sc["m_inv"][1]))
    assert torch.equal(got[1][1], _t(sc["s"][1]))
    assert not bool(got[2][1].any())
    for b in range(B):
        single = sweep_ops.commit_sweep(*[a[b] for a in _probe_args(sc)], i,
                                        _t(sc["delta"][b]), 1.0, 0.0,
                                        float(thr[b]), True)
        assert bool(single[3]) == bool(got[3][b])
        for k in (0, 1, 2, 4):
            _close(got[k][b].numpy(), single[k].numpy(), 1e-5,
                   f"commit slice {b} output {k}")


@pytest.mark.parametrize("n", [160, 400])
def test_sweep_refs_batched_match_jax_f64(n):
    """The native-dtype batched plain versions against the JAX refs under
    vmap, both float64."""
    sc = _scenes(n, seed=7, dtype=np.float64)
    i = 1
    thr = np.asarray([-np.inf, np.inf, -np.inf])
    with jax.enable_x64(True):
        jargs = _probe_args(sc, torch_side=False)
        steps = jnp.asarray(sc["steps"])
        pj = jax.vmap(lambda r, m, s, e: jsweep_ref.probe_sweep_ref(
            r, m, s, e, i, steps))(*jargs)
        cj = jax.vmap(lambda r, m, s, e, dl, th: jsweep_ref.commit_sweep_ref(
            r, m, s, e, i, dl, 1.0, 0.0, th, 1.0))(
                *jargs, jnp.asarray(sc["delta"]), jnp.asarray(thr))
        pj, cj = [np.asarray(a) for a in pj], [np.asarray(a) for a in cj]
    pt = sweep_ref.probe_sweep_batched_ref(*_probe_args(sc), i, _t(sc["steps"]))
    ct = sweep_ref.commit_sweep_batched_ref(*_probe_args(sc), i,
                                            _t(sc["delta"]), 1.0, 0.0,
                                            _t(thr), True)
    assert pt[0].dtype == torch.float64
    for g, w in zip(pt, pj):
        _close(g.numpy(), w, 1e-12, "probe f64")
    for k in (0, 1, 2, 4):
        _close(ct[k].numpy(), cj[k], 1e-12, f"commit f64 output {k}")
    assert ct[3].tolist() == cj[3].tolist() == [True, False, True]


def test_batched_wrappers_refuse_bad_shapes():
    sc = _scenes(64)
    r, m_inv, s, eta = _probe_args(sc)
    with pytest.raises(ValueError, match="m_inv"):
        sweep_ops.probe_sweep(r, m_inv[:2], s, eta, 0, _t(sc["steps"]))
    with pytest.raises(ValueError, match="delta"):
        sweep_ops.commit_sweep(r, m_inv, s, eta, 0, _t(sc["delta"][:, :5]),
                               1.0, 0.0, -math.inf, True)
    with pytest.raises(ValueError, match="v of shape"):
        gram_ops.row_gram(_t(sc["v"][:2]), r)
    with pytest.raises(ValueError, match=r"\(B, D, N\)"):
        gram_ops.gram(r[None])
    with pytest.raises(IndexError):
        sweep_ops.probe_sweep(r, m_inv, s, eta, D, _t(sc["steps"]))


def test_plain_versions_count_no_launch():
    """On CPU tensors the wrappers run the plain versions: no kernel, no
    count."""
    sc = _scenes(64)
    _build.reset_launches()
    gram_ops.gram(_t(sc["r"]))
    gram_ops.row_gram(_t(sc["v"]), _t(sc["r"]))
    sweep_ops.probe_sweep(*_probe_args(sc), 0, _t(sc["steps"]))
    assert all(v == 0 for v in _build.LAUNCHES.values())
    assert set(BATCHED_KEYS) <= set(_build.LAUNCHES)


# ------------------------------------------------------------------- run_scan


def _trial_arrays(n, dtype):
    """B Friedman-1 trials (data seeds 0..B-1) from the JAX package's
    generator, one attribute per agent, as numpy (B, ...) arrays."""
    parts = [[], [], [], []]
    for t in range(B):
        xtr, ytr, xte, yte = make_dataset(1, n_train=n, n_test=n, seed=t)
        for out, a in zip(parts, (np.asarray(xtr).T[:, :, None], ytr,
                                  np.asarray(xte).T[:, :, None], yte)):
            out.append(np.asarray(a, dtype))
    return [np.stack(p) for p in parts]


@pytest.fixture(scope="module")
def single_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (precision, use_kernel, N, sweeps, degree) -> tolerance on the histories
SCAN_CASES = {("f64", False, 400, 3, 4): 1e-10,
              ("f64", True, 160, 2, 3): 1e-5,
              ("f32", True, 160, 3, 4): 3e-5,
              ("f32", False, 400, 2, 3): 3e-5}


@pytest.fixture(scope="module")
def scans(single_thread):
    """{(case, engine): (jax hist, port hist, port f, jax f)}."""
    out = {}
    for case in SCAN_CASES:
        precision, uk, n, sweeps, degree = case
        dtype = np.float64 if precision == "f64" else np.float32
        arrays = _trial_arrays(n, dtype)
        for engine in ENGINES:
            with jax.enable_x64(precision == "f64"):
                cfg = jicoa.ICOAConfig(n_sweeps=sweeps, engine=engine,
                                       use_kernel=uk)
                _, fj, _, hj = jax.vmap(
                    lambda x, y, xt, yt, seed: jicoa.run_scan(
                        JPoly(1, degree), cfg, x, y, xt, yt, seed))(
                            *map(jnp.asarray, arrays), jnp.arange(B))
                hj = {k: np.asarray(v) for k, v in hj.items() if k != "taps"}
                fj = np.asarray(fj)
            tcfg = ticoa.ICOAConfig(n_sweeps=sweeps, engine=engine,
                                    use_kernel=uk)
            _, ft, _, ht = ticoa.run_scan(TPoly(1, degree), tcfg,
                                          *convert.batch_from_numpy(*arrays))
            out[(case, engine)] = (hj, ht, ft.numpy(), fj)
    return out


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", list(SCAN_CASES), ids=lambda c: "-".join(
    map(str, c)))
def test_run_scan_matches_jax_vmap(scans, case, engine):
    hj, ht, ft, fj = scans[(case, engine)]
    tol = SCAN_CASES[case]
    sweeps = case[3]
    for key in KEYS:
        assert ht[key].shape == (B, sweeps + 1), key
        np.testing.assert_allclose(ht[key].numpy(), hj[key], rtol=tol,
                                   err_msg=key)
    assert ht["converged_at"].tolist() == hj["converged_at"].tolist()
    np.testing.assert_array_equal(np.broadcast_to(ht["bytes"], (B, sweeps + 1)),
                                  hj["bytes"])
    assert ht["bytes"][1:] == [2.0 * case[2] * D * 8] * sweeps
    if case[0] == "f64" and not case[1]:
        np.testing.assert_allclose(ft, fj, rtol=1e-10, atol=1e-12)


def test_run_scan_engines_agree_f64(scans):
    case = ("f64", False, 400, 3, 4)
    _, hi, _, _ = scans[(case, "incremental")]
    _, hf, _, _ = scans[(case, "fused")]
    for key in KEYS:
        np.testing.assert_allclose(hf[key].numpy(), hi[key].numpy(), rtol=1e-10)


def test_converged_record_tensor_matches_jax():
    etas = [[1.0, 0.5, 0.4, 0.4, 0.3], [3.0, 2.0, 1.0, 0.5, 0.25],
            [1.0, 0.5, 0.5, 0.5, 0.5]]
    got = ticoa.converged_record(torch.tensor(etas, dtype=torch.float32), 1e-7)
    want = [int(jicoa.converged_record(jnp.asarray(e, jnp.float32), 1e-7))
            for e in etas]
    assert got.tolist() == want == [3, 4, 2]
    for e in ([1.0], [1.0, 0.5]):
        assert ticoa.converged_record(torch.tensor([e]), 1e-7).tolist() == [
            ticoa.converged_record(e, 1e-7)]


def test_run_scan_slice_equals_run_f64(single_thread):
    """One batched run_scan against B serial `run`s (eps 0, so no early
    stop) on the same arrays, float64."""
    arrays = convert.batch_from_numpy(*_trial_arrays(160, np.float64))
    cfg = ticoa.ICOAConfig(n_sweeps=2, engine="incremental", eps=0.0)
    _, f, w, hist = ticoa.run_scan(TPoly(1, 4), cfg, *arrays)
    for b in range(B):
        state, wb, hb = ticoa.run(TPoly(1, 4), cfg, *(a[b] for a in arrays))
        for key in KEYS:
            np.testing.assert_allclose(hist[key][b].numpy(), hb[key], rtol=1e-12)
        assert hist["bytes"] == hb["bytes"]
        np.testing.assert_allclose(f[b].numpy(), state.f.numpy(), rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(w[b].numpy(), wb.numpy(), rtol=1e-10)


def test_run_scan_refuses_unbatched(single_thread):
    x, y, xt, yt = convert.batch_from_numpy(*_trial_arrays(160, np.float64))
    with pytest.raises(ValueError, match="run_scan"):
        ticoa.run_scan(TPoly(1, 4), ticoa.ICOAConfig(n_sweeps=1), x[0], y[0],
                       xt[0], yt[0])
    with pytest.raises(ValueError, match="trial axes"):
        convert.batch_from_numpy(np.zeros((2, 5, 8, 1)), np.zeros((3, 8)),
                                 np.zeros((2, 5, 8, 1)), np.zeros((2, 8)))


# ------------------------------------------------------------------ batch_fit


def _spec(engine="incremental", **solver_kw):
    solver_kw.setdefault("n_sweeps", 3)
    return tapi.ExperimentSpec(
        data=tapi.DataSpec(n_train=400, n_test=200, seed=11),
        agent=tapi.AgentSpec(options=(("degree", 3),)),
        solver=tapi.SolverSpec(engine=engine, **solver_kw), seed=5)


@pytest.fixture
def default_f64():
    dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(dt)


@pytest.mark.parametrize("engine", ENGINES)
def test_batch_fit_trial_equals_fit_f64(single_thread, default_f64, engine):
    """Data generated in float64 on both sides: trial t of batch_fit is
    fit(trial_spec(spec, t)) to 1e-10, bytes and converged_at equal (eps 0
    keeps fit from stopping early)."""
    spec = _spec(engine, eps=0.0)
    rs = tapi.batch_fit(spec, B, device="cpu")
    assert len(rs) == B and [r.spec for r in rs] == [
        tapi.trial_spec(spec, t) for t in range(B)]
    assert rs[1].spec.seed == 6 and rs[1].spec.data.seed == 12
    for t, res in enumerate(rs):
        one = tapi.fit(tapi.trial_spec(spec, t), device="cpu")
        for key in KEYS:
            np.testing.assert_allclose(getattr(res.history, key),
                                       getattr(one.history, key), rtol=1e-10,
                                       err_msg=f"trial {t} {key}")
        assert res.history.bytes_transmitted == one.history.bytes_transmitted
        assert res.history.converged_at == one.history.converged_at == 3
        np.testing.assert_allclose(res.weights.numpy(), one.weights.numpy(),
                                   rtol=1e-9)
        assert res.params.shape == one.params.shape


@pytest.mark.parametrize("engine", ENGINES)
def test_batch_fit_kernel_path_matches_fit_f32(single_thread, engine):
    """float32 with use_kernel on CPU tensors (the kernels' plain versions):
    trial t within 1e-4 of fit(trial_spec(spec, t)), the tolerance the card
    check holds batch_fit to."""
    spec = _spec(engine, use_kernel=True, eps=0.0)
    rs = tapi.batch_fit(spec, B, device="cpu")
    for t, res in enumerate(rs):
        one = tapi.fit(tapi.trial_spec(spec, t), device="cpu")
        assert res.history.bytes_transmitted == one.history.bytes_transmitted
        for key in KEYS:
            np.testing.assert_allclose(getattr(res.history, key),
                                       getattr(one.history, key), rtol=1e-4)


def test_batch_fit_static_schedule_reports_convergence(single_thread):
    """eps stops nothing in the batch: every trial records all sweeps, and
    converged_at says where fit would have stopped."""
    spec = _spec(eps=1e-2, n_sweeps=4)
    rs = tapi.batch_fit(spec, B, device="cpu")
    for t, res in enumerate(rs):
        assert len(res.history.eta) == 5
        assert res.history.converged_at == ticoa.converged_record(
            res.history.eta, 1e-2)
        one = tapi.fit(tapi.trial_spec(spec, t), device="cpu")
        assert len(one.history.eta) - 1 == res.history.converged_at


def test_batch_fit_serial_path_and_compute_dtype(single_thread):
    spec = _spec(n_sweeps=2, eps=0.0)
    ser = tapi.batch_fit(spec, 2, device="cpu", compiled=False)
    bat = tapi.batch_fit(spec, 2, device="cpu")
    for a, b in zip(ser, bat):
        np.testing.assert_allclose(a.history.eta, b.history.eta, rtol=1e-4)
    spec64 = tapi.ExperimentSpec(data=spec.data, agent=spec.agent,
                                 solver=spec.solver,
                                 backend=tapi.BackendSpec(compute_dtype="float64",
                                                          donate=False))
    rs64 = tapi.batch_fit(spec64, 2, device="cpu")
    assert rs64[0].f.dtype == torch.float64
    np.testing.assert_allclose(rs64[0].history.eta, bat[0].history.eta,
                               rtol=1e-4)


def test_batch_fit_needs_a_card_unless_asked(single_thread):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: batch_fit runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.batch_fit(_spec(), 2)
    with pytest.raises(tapi.SpecError, match="n_trials"):
        tapi.batch_fit(_spec(), 0, device="cpu")


@pytest.mark.parametrize("spec,item", [
    pytest.param(tapi.ExperimentSpec(backend=tapi.BackendSpec(trial_devices=2)),
                 "A11b", id="spec0-A11"),
])
def test_batch_fit_raises_not_ported(spec, item):
    with pytest.raises(tapi.NotPortedError, match=rf"ROADMAP {item}\b"):
        tapi.batch_fit(spec, 2, device="cpu")


@pytest.mark.parametrize("change", [
    dict(solver=dict(engine="dense", row_broadcast=True)),
    dict(solver=dict(engine="dense", alpha=20.0, delta=0.01, minimax_steps=40)),
    dict(data=dict(source="cosine", n_attrs=4)),
    dict(data=dict(source="correlated_linear", n_attrs=8, n_agents=4,
                   partition="blocks"), solver=dict(engine="fused")),
], ids=["dense-row-broadcast", "dense-minimax", "cosine", "blocks-fused"])
def test_batch_fit_of_formerly_unported_specs_equals_fit_f64(
        single_thread, default_f64, change):
    """What batch_fit used to refuse (the dense engine, ROADMAP A4b; the
    cosine source and the partitions, A7) runs as one batch, trial t
    equal to fit(trial_spec(spec, t))."""
    d = {"data": dict(n_train=160, n_test=80, **change.get("data", {})),
         "solver": dict(n_sweeps=2, eps=0.0, **change.get("solver", {})),
         "seed": 1}
    spec = tapi.spec_from_dict(d)
    rs = tapi.batch_fit(spec, B, device="cpu")
    for t, res in enumerate(rs):
        one = tapi.fit(tapi.trial_spec(spec, t), device="cpu")
        for key in KEYS:
            np.testing.assert_allclose(getattr(res.history, key),
                                       getattr(one.history, key), rtol=1e-10,
                                       err_msg=f"trial {t} {key}")
        assert res.history.bytes_transmitted == one.history.bytes_transmitted


DENSE_GRID = [(1.0, 0.0), (20.0, 0.0), (1.0, 0.02), (20.0, 0.01)]


@pytest.mark.parametrize("row_broadcast", [False, True], ids=["gather", "rows"])
@pytest.mark.parametrize("alpha,delta", DENSE_GRID,
                         ids=[f"a{a:g}-d{d:g}" for a, d in DENSE_GRID])
def test_run_scan_dense_matches_jax_vmap_f64(single_thread, alpha, delta,
                                             row_broadcast):
    """The batched dense engine against jax.vmap over the JAX package's
    dense run_scan (seeds 5, 6, 7: each trial its own subsamples), and
    each trial's slice against the port's single-trial dense run."""
    arrays = _trial_arrays(160, np.float64)
    kw = dict(n_sweeps=2, engine="dense", alpha=alpha, delta=delta,
              minimax_steps=40, row_broadcast=row_broadcast)
    with jax.enable_x64(True):
        cfg = jicoa.ICOAConfig(**kw)
        _, fj, wj, hj = jax.vmap(lambda x, y, xt, yt, seed: jicoa.run_scan(
            JPoly(1, 4), cfg, x, y, xt, yt, seed))(
                *map(jnp.asarray, arrays), jnp.arange(B) + 5)
        hj = {k: np.asarray(v) for k, v in hj.items() if k != "taps"}
    tcfg = ticoa.ICOAConfig(**kw)
    _, ft, wt, ht = ticoa.run_scan(TPoly(1, 4), tcfg,
                                   *convert.batch_from_numpy(*arrays),
                                   seeds=[5, 6, 7])
    for key in KEYS:
        np.testing.assert_allclose(ht[key].numpy(), hj[key], rtol=1e-10,
                                   err_msg=key)
    np.testing.assert_array_equal(np.broadcast_to(ht["bytes"], (B, 3)),
                                  hj["bytes"])
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-10, atol=1e-12)
    for b in range(B):
        one = [torch.from_numpy(a[b]) for a in arrays]
        state, w1, h1 = ticoa.run(TPoly(1, 4), dataclasses.replace(tcfg, eps=0.0),
                                  *one, seed=5 + b)
        for key in KEYS:
            np.testing.assert_allclose(ht[key][b].numpy(), h1[key], rtol=1e-10,
                                       err_msg=f"trial {b} {key}")
        np.testing.assert_allclose(ft[b].numpy(), state.f.numpy(), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("engine", ENGINES)
def test_run_scan_minimax_matches_jax_vmap_f64(single_thread, engine):
    """alpha = 20, delta = 0.01: every trial draws its own subsample from its
    own key (seeds 5, 6, 7), as jax.vmap(run_scan) over the seeds does."""
    arrays = _trial_arrays(400, np.float64)
    kw = dict(n_sweeps=3, engine=engine, alpha=20.0, delta=0.01,
              minimax_steps=80)
    with jax.enable_x64(True):
        cfg = jicoa.ICOAConfig(**kw)
        _, fj, wj, hj = jax.vmap(lambda x, y, xt, yt, seed: jicoa.run_scan(
            JPoly(1, 4), cfg, x, y, xt, yt, seed))(
                *map(jnp.asarray, arrays), jnp.arange(B) + 5)
        hj = {k: np.asarray(v) for k, v in hj.items() if k != "taps"}
        fj, wj = np.asarray(fj), np.asarray(wj)
    _, ft, wt, ht = ticoa.run_scan(TPoly(1, 4), ticoa.ICOAConfig(**kw),
                                   *convert.batch_from_numpy(*arrays),
                                   seeds=[5, 6, 7])
    for key in KEYS:
        np.testing.assert_allclose(ht[key].numpy(), hj[key], rtol=1e-10,
                                   err_msg=key)
    assert ht["converged_at"].tolist() == hj["converged_at"].tolist()
    np.testing.assert_array_equal(np.broadcast_to(ht["bytes"], (B, 4)),
                                  hj["bytes"])
    assert ht["bytes"][1:] == [2.0 * 5 * (20 * 8 + 8)] * 3
    np.testing.assert_allclose(ft.numpy(), fj, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(wt.numpy(), wj, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("engine", ENGINES)
def test_batch_fit_minimax_trial_equals_fit_f64(single_thread, default_f64,
                                                engine):
    """alpha = 20, delta = 0.01: batch_fit's trial t is
    fit(trial_spec(spec, t)) — the same subsamples, from seed + t + 1."""
    spec = _spec(engine, eps=0.0, n_sweeps=2, alpha=20.0, delta=0.01,
                 minimax_steps=60)
    rs = tapi.batch_fit(spec, B, device="cpu")
    for t, res in enumerate(rs):
        one = tapi.fit(tapi.trial_spec(spec, t), device="cpu")
        for key in KEYS:
            np.testing.assert_allclose(getattr(res.history, key),
                                       getattr(one.history, key), rtol=1e-10,
                                       err_msg=f"trial {t} {key}")
        assert res.history.bytes_transmitted == one.history.bytes_transmitted
        np.testing.assert_allclose(res.weights.numpy(), one.weights.numpy(),
                                   rtol=1e-9, atol=1e-12)


def test_trial_devices_beyond_the_host_is_a_spec_error():
    spec = tapi.ExperimentSpec(backend=tapi.BackendSpec(trial_devices=64))
    with pytest.raises(tapi.SpecError, match="only 1 cpu device"):
        tapi.batch_fit(spec, 2, device="cpu")


# ------------------------------------------------------------------ ResultSet


def _histories(seed=0):
    rng = np.random.default_rng(seed)
    return [dict(train_mse=list(rng.random(4)), test_mse=list(rng.random(4)),
                 eta=list(rng.random(4)),
                 bytes_transmitted=[0.0, 64000.0, 64000.0, 64000.0],
                 converged_at=int(rng.integers(2, 4))) for _ in range(B)]


def _result_sets(hists):
    jrs = JResultSet(japi.ExperimentSpec(), [
        JResult(spec=None, family=None, params=None, weights=None, f=None,
                history=JHistory(**h)) for h in hists])
    trs = tapi.ResultSet(tapi.ExperimentSpec(), [
        tapi.Result(spec=None, family=None, params=None, weights=None, f=None,
                    history=tapi.History(**h)) for h in hists])
    return jrs, trs


def test_result_set_matches_jax():
    jrs, trs = _result_sets(_histories())
    assert len(trs) == len(jrs) == B and trs.n_records == jrs.n_records
    for field in KEYS:
        np.testing.assert_array_equal(trs.stack(field), jrs.stack(field))
        np.testing.assert_array_equal(trs.mean(field), jrs.mean(field))
        np.testing.assert_array_equal(trs.std(field), jrs.std(field))
        for a, b in zip(trs.curve(field), jrs.curve(field)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(trs.cumulative_bytes, jrs.cumulative_bytes)
    assert trs.converged_sweeps == jrs.converged_sweeps
    assert trs.test_mse_mean == jrs.test_mse_mean
    assert trs.test_mse_std == jrs.test_mse_std
    assert [r.history.eta for r in trs] == [r.history.eta for r in jrs]
    assert trs[1].history.eta == jrs[1].history.eta


def test_result_set_refuses_diverging_ledgers_as_jax_does():
    hists = _histories(1)
    hists[2]["bytes_transmitted"] = [0.0, 64000.0, 32000.0, 64000.0]
    jrs, trs = _result_sets(hists)
    for rs in (jrs, trs):
        with pytest.raises(ValueError, match="trial 2 record 2"):
            rs.cumulative_bytes


def test_result_set_truncates_to_the_shortest_trial():
    hists = _histories(2)
    for key in ("train_mse", "test_mse", "eta", "bytes_transmitted"):
        hists[0][key] = hists[0][key][:3]
    jrs, trs = _result_sets(hists)
    assert trs.n_records == jrs.n_records == 3
    np.testing.assert_array_equal(trs.mean("eta"), jrs.mean("eta"))


# ---------------------------------------------------------------------- grids


GRID = {"solver.n_sweeps": [2, 3], "data.noise": [0.0, 0.1, 0.2],
        "seed": [1, 4]}


def _points(specs):
    return [(s.solver.n_sweeps, s.data.noise, s.seed) for s in specs]


def test_grid_specs_enumerate_as_jax():
    got = _points(tapi.grid_specs(tapi.ExperimentSpec(), GRID))
    assert got == _points(japi.grid_specs(japi.ExperimentSpec(), GRID))
    assert len(got) == 12 and got[:2] == [(2, 0.0, 1), (2, 0.0, 4)]


def test_zip_specs_enumerate_as_jax():
    grid = {"solver.n_sweeps": [2, 3], "data.noise": [0.0, 0.1],
            "seed": [1, 4]}
    got = _points(tapi.zip_specs(tapi.ExperimentSpec(), grid))
    assert got == _points(japi.zip_specs(japi.ExperimentSpec(), grid))
    assert got == [(2, 0.0, 1), (3, 0.1, 4)]
    with pytest.raises(tapi.SpecError, match="equal-length"):
        list(tapi.zip_specs(tapi.ExperimentSpec(), GRID))
    with pytest.raises(tapi.SpecError, match="no field"):
        tapi.spec_with(tapi.ExperimentSpec(), "solverr.alpha", 2.0)


def test_sweep_over_a_grid(single_thread):
    base = _spec(n_sweeps=2)
    rsets = tapi.sweep(base, {"data.noise": [0.0, 0.1]}, trials=2,
                       device="cpu")
    assert [rs.spec.data.noise for rs in rsets] == [0.0, 0.1]
    assert all(len(rs) == 2 and rs.curve()[0].shape == (3,) for rs in rsets)
    results = tapi.sweep(base, {"solver.n_sweeps": [1, 2]}, device="cpu")
    assert [len(r.history.eta) for r in results] == [2, 3]
    # the paper's trade-off grid runs: fewer bytes at the higher rate
    grid = tapi.sweep(base, {"solver.alpha": [1.0, 10.0]}, trials=2,
                      device="cpu")
    assert [rs.spec.solver.alpha for rs in grid] == [1.0, 10.0]
    assert grid[1].cumulative_bytes[-1] < grid[0].cumulative_bytes[-1] / 9
    # a grid over dense batches: the paper's gather-per-update schedule
    # against the row-wise one, D times fewer bytes
    dense = tapi.sweep(_spec(n_sweeps=2, engine="dense"),
                       {"solver.row_broadcast": [False, True]}, trials=2,
                       device="cpu")
    assert [len(rs) for rs in dense] == [2, 2]
    assert dense[0].cumulative_bytes[-1] == D * dense[1].cumulative_bytes[-1] / 2
