"""repro_torch.core.icoa against repro.core.icoa: whole-run histories.

The Friedman-1 D=5, N=600 arrays of test_fused_engine._friedman, degree-4
polynomial agents, 10 sweeps, the same numpy inputs on both sides; per-sweep
train_mse, test_mse, eta and bytes:

  * float64, use_kernel=False, both engines: rtol 1e-10 (the repo's own
    engine contract), bytes exactly equal;
  * float32, use_kernel=True, both engines — the JAX package through its
    Pallas kernels in interpret mode, the port through its kernels' plain
    versions (these are CPU tensors): rtol 1e-5, the kernel-path precedent
    of DESIGN.md §7.  The back-search and accept decisions are knife edges
    in fp32, so whole-history parity is a D=5 statement; the port runs
    single-threaded here so that its fp32 sums have one order on any host;
  * one sweep started from a JAX mid-run state carried across by
    repro_torch.convert.

Each JAX reference run happens once, in a module-scoped fixture.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.agents import PolynomialFamily as JPoly
from repro.core import icoa as jicoa
from repro.data.friedman import make_dataset
from repro.data.partition import one_per_agent
from repro_torch import convert
from repro_torch.agents import PolynomialFamily as TPoly
from repro_torch.core import ensemble
from repro_torch.core import icoa as ticoa

KEYS = ("train_mse", "test_mse", "eta")
ENGINES = ("incremental", "fused")


def _friedman(n=600):
    xtr, ytr, xte, yte = make_dataset(1, n_train=n, n_test=n, seed=0)
    groups = one_per_agent(5)
    return [np.asarray(a) for a in (jnp.stack([xtr[:, g] for g in groups]), ytr,
                                    jnp.stack([xte[:, g] for g in groups]), yte)]


@pytest.fixture(scope="module")
def single_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(single_thread):
    """{(precision, engine): (jax history, port history)}."""
    out = {}
    for precision, dtype, uk in (("f64", np.float64, False),
                                 ("f32", np.float32, True)):
        with jax.enable_x64(precision == "f64"):
            arrays = [a.astype(dtype) for a in _friedman()]
            for engine in ENGINES:
                _, _, hj = jicoa.run(JPoly(1, 4), jicoa.ICOAConfig(
                    n_sweeps=10, engine=engine, use_kernel=uk),
                    *map(jnp.asarray, arrays))
                _, _, ht = ticoa.run(TPoly(1, 4), ticoa.ICOAConfig(
                    n_sweeps=10, engine=engine, use_kernel=uk),
                    *map(torch.from_numpy, arrays))
                out[(precision, engine)] = (hj, ht)
    return out


def _assert_history(hj, ht, rtol):
    assert hj["bytes"] == ht["bytes"]
    for key in KEYS:
        assert len(hj[key]) == len(ht[key]), key
        np.testing.assert_allclose(ht[key], hj[key], rtol=rtol, err_msg=key)


@pytest.mark.parametrize("engine", ENGINES)
def test_history_matches_jax_f64(runs, engine):
    hj, ht = runs[("f64", engine)]
    _assert_history(hj, ht, rtol=1e-10)
    assert ht["bytes"][1:] == [2 * 600 * 5 * 8.0] * (len(ht["eta"]) - 1)


@pytest.mark.parametrize("engine", ENGINES)
def test_history_matches_jax_f32_kernel_path(runs, engine):
    hj, ht = runs[("f32", engine)]
    _assert_history(hj, ht, rtol=1e-5)


def test_engines_agree_within_port_f64(runs):
    """The fused engine reproduces the incremental one (its parity oracle)."""
    _, hi = runs[("f64", "incremental")]
    _, hf = runs[("f64", "fused")]
    _assert_history(hi, hf, rtol=1e-10)


def test_eta_falls_every_sweep(runs):
    for (precision, engine), (_, ht) in runs.items():
        eta = np.asarray(ht["eta"])
        assert np.all(eta[1:] <= eta[:-1] * (1 + 1e-6)), (precision, engine, eta)


@pytest.mark.parametrize("engine", ENGINES)
def test_sweep_from_jax_midrun_state(single_thread, engine):
    """Carry a JAX state after 3 sweeps across; one more sweep on each side
    must give the same params and predictions (f64, 1e-10)."""
    fam_j, fam_t = JPoly(1, 4), TPoly(1, 4)
    with jax.enable_x64(True):
        xc, y, _, _ = [jnp.asarray(a) for a in _friedman()]
        cfg_j = jicoa.ICOAConfig(n_sweeps=3, engine=engine)
        state, _, _ = jicoa.run(fam_j, cfg_j, xc, y)
        params, f, _, ledger, _ = jicoa.sweep(fam_j, cfg_j, state.params,
                                              state.f, xc, y, state.key)
        params, f = np.asarray(params), np.asarray(f)
        mid = convert.state_from_numpy(np.asarray(state.params),
                                       np.asarray(state.f))
    cfg_t = ticoa.ICOAConfig(n_sweeps=3, engine=engine)
    p_t, f_t, led_t, taps = ticoa.sweep(fam_t, cfg_t, mid.params, mid.f,
                                        torch.from_numpy(np.array(xc)),
                                        torch.from_numpy(np.array(y)))
    assert taps == {}                       # no ObsSpec: no taps
    assert p_t.dtype == torch.float64
    np.testing.assert_allclose(p_t.numpy(), params, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(f_t.numpy(), f, rtol=1e-10, atol=1e-12)
    assert led_t.spent == int(ledger.spent)
    # the state carried in is left as it was
    assert torch.equal(mid.params, torch.from_numpy(np.array(state.params)))


def test_converged_record_matches_jax():
    for eta in ([1.0], [1.0, 0.5], [1.0, 0.5, 0.4, 0.4, 0.3],
                [3.0, 2.0, 1.0, 0.5]):
        assert ticoa.converged_record(eta, 1e-7) == int(
            jicoa.converged_record(jnp.asarray(eta, jnp.float32), 1e-7))


def test_config_rejects_unported():
    """Minimax Protection and the dense engine validate; what still raises is
    the dense engine on a kernel (the reference has none: its Pallas Gram
    cannot be differentiated).  A batched dense engine runs: a batch of one
    is the single-trial run."""
    ticoa.ICOAConfig(alpha=20.0, delta=0.1, engine="dense").validate()
    with pytest.raises(ValueError, match="pallas_call's JVP rule"):
        ticoa.ICOAConfig(engine="dense", use_kernel=True).validate()
    xc, y, xt, yt = [torch.from_numpy(a.copy()) for a in _friedman(n=60)]
    cfg = ticoa.ICOAConfig(engine="dense", n_sweeps=2, eps=0.0)
    _, f_b, _, h_b = ticoa.run_scan(TPoly(1, 4), cfg, xc[None], y[None],
                                    xt[None], yt[None])
    state, _, h = ticoa.run(TPoly(1, 4), cfg, xc, y, xt, yt)
    assert torch.equal(f_b[0], state.f)
    for key in KEYS:
        np.testing.assert_allclose(h_b[key][0].numpy(), h[key], rtol=1e-6,
                                   err_msg=key)


# ------------------------------------------------------------ solver knobs

KNOBS = {"accept_reject_off": dict(accept_reject=False),
         "max_probes_1": dict(max_probes=1), "max_probes_2": dict(max_probes=2),
         "max_probes_3": dict(max_probes=3), "backtrack_0.3": dict(backtrack=0.3),
         "step0_0.05": dict(step0=0.05), "step0_20": dict(step0=20.0),
         "eps_1e-3": dict(eps=1e-3), "n_sweeps_1": dict(n_sweeps=1)}


@pytest.fixture(scope="module")
def f64_arrays():
    with jax.enable_x64(True):
        return [a.astype(np.float64) for a in _friedman()]


@pytest.fixture(scope="module")
def jax_knob_runs(single_thread, f64_arrays):
    """{(knob case, engine): JAX f64 history}, each run made once."""
    cache = {}

    def get(case, engine):
        if (case, engine) not in cache:
            cfg = {"n_sweeps": 10, "engine": engine, **KNOBS[case]}
            with jax.enable_x64(True):
                cache[(case, engine)] = jicoa.run(
                    JPoly(1, 4), jicoa.ICOAConfig(**cfg),
                    *map(jnp.asarray, f64_arrays))[2]
        return cache[(case, engine)]
    return get


def _max_rel(a, b):
    return max(float(np.max(np.abs(np.subtract(a[k], b[k])) / np.abs(b[k])))
               for k in KEYS)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", list(KNOBS))
def test_solver_knobs_match_jax_f64(jax_knob_runs, f64_arrays, case, engine):
    """The knobs that set the back-search schedule and the stopping rule,
    one at a time, in float64 on both sides from the same numpy arrays:
    histories within rtol 1e-10, bytes equal.  At step0=20 the schedule's
    first steps are large and the closed-form pivots cancel: there the JAX
    package's own two engines differ by up to ~1.7e-10 on this data, so the
    bound is the larger of 1e-10 and that gap (elsewhere the gap is below
    1e-12 and the bound is 1e-10)."""
    hj = jax_knob_runs(case, engine)
    cfg = {"n_sweeps": 10, "engine": engine, **KNOBS[case]}
    ht = ticoa.run(TPoly(1, 4), ticoa.ICOAConfig(**cfg),
                   *map(torch.from_numpy, f64_arrays))[2]
    gap = _max_rel(jax_knob_runs(case, "fused"), jax_knob_runs(case, "incremental"))
    _assert_history(hj, ht, rtol=max(1e-10, gap))
    assert len(ht["eta"]) == {"n_sweeps_1": 2}.get(case, len(hj["eta"]))


# ------------------------------------------------------------- TF32 scope


@pytest.mark.parametrize("flag", [True, False])
def test_run_leaves_tf32_flag_as_found(flag):
    """run and run_scan switch TF32 off for their own products only: the
    caller's torch.backends.cuda.matmul.allow_tf32 is the same after."""
    xc, y, xt, yt = [torch.from_numpy(a) for a in _friedman(n=60)]
    cfg = ticoa.ICOAConfig(n_sweeps=1)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = flag
        ticoa.run(TPoly(1, 4), cfg, xc, y, xt, yt)
        assert torch.backends.cuda.matmul.allow_tf32 is flag
        ticoa.run_scan(TPoly(1, 4), cfg, xc[None], y[None], xt[None], yt[None])
        assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


# ------------------------------------------------------- Minimax Protection

# (alpha, delta): the grid of the JAX package's own engine tests
# (tests/test_core_icoa.py), each run 4 sweeps with an 80-step inner solver
MM_GRID = [(1.0, 0.0), (20.0, 0.0), (1.0, 0.02), (20.0, 0.01)]
ENGINES3 = ("dense", "incremental", "fused")
MM = dict(n_sweeps=4, minimax_steps=80)
MM_SEED = 3


def _mm_id(case):
    return "alpha{}-delta{}".format(*case)


@pytest.fixture(scope="module")
def mm_runs(single_thread):
    """{(precision, engine, alpha, delta): (jax (state, w, hist), port
    (state, w, hist))}: float64 without kernels for all three engines;
    float32 with use_kernel for the incremental and fused engines (the JAX
    package's Pallas kernels in interpret mode, the port's plain versions)."""
    out = {}
    for precision, dtype, uk, engines in (
            ("f64", np.float64, False, ENGINES3),
            ("f32", np.float32, True, ENGINES)):
        with jax.enable_x64(precision == "f64"):
            arrays = [a.astype(dtype) for a in _friedman()]
            for engine in engines:
                for alpha, delta in MM_GRID:
                    kw = dict(MM, engine=engine, alpha=alpha, delta=delta,
                              use_kernel=uk)
                    j = jicoa.run(JPoly(1, 4), jicoa.ICOAConfig(**kw),
                                  *map(jnp.asarray, arrays), seed=MM_SEED)
                    t = ticoa.run(TPoly(1, 4), ticoa.ICOAConfig(**kw),
                                  *map(torch.from_numpy, arrays), seed=MM_SEED)
                    out[(precision, engine, alpha, delta)] = (j, t)
    return out


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


@pytest.mark.parametrize("case", MM_GRID, ids=_mm_id)
@pytest.mark.parametrize("engine", ENGINES3)
def test_minimax_run_matches_jax_f64(mm_runs, engine, case):
    """Histories, the final weights and predictions within 1e-10 of
    repro.core.icoa.run on the same engine, bytes exactly equal (at
    alpha = 20 each payload carries the exact diagonal scalar)."""
    (sj, wj, hj), (st, wt, ht) = mm_runs[("f64", engine, *case)]
    _assert_history(hj, ht, rtol=1e-10)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(st.f.numpy(), np.asarray(sj.f), rtol=1e-10,
                               atol=1e-12)
    m = 600 if case[0] == 1.0 else 30
    per_payload = 8 * m + (8 if case[0] > 1.0 else 0)
    per_sweep = (2 if engine != "dense" else 5) * 5 * per_payload
    assert ht["bytes"][1:] == [float(per_sweep)] * (len(ht["eta"]) - 1)


# fp32 kernel path, port vs the JAX package (max relative difference over
# the records).  At alpha = 1, delta = 0 the 1e-5 contract of DESIGN.md §7.
# At alpha = 20 a record's weights come from 30 transmitted instances, are
# of size ~3 and cancel in the ensemble.  The two programs' fp32 sweeps
# leave predictions f that differ by 2e-5 to 8e-5 (normwise) after four
# sweeps at alpha = 20 (1e-5 at alpha = 1), and those weights amplify that
# in train/test MSE, while eta (full data, no such weights) stays within
# 1e-5.  test_f32_gap_is_the_predictions_amplified is the witness: given
# the JAX run's final f, the port's last record is within 1e-5 of the JAX
# package's (1.8e-6 at most).  The difference in f is not the fits' alone:
# giving the port the JAX package's fp32 fits at every agent update does
# not close the (20, 0) gap.  At delta > 0 the best-iterate rule of the
# robust solver picks on fp32 knife edges as well, and the trajectories part
# a little.  Measured on this data, max over both engines (train/test MSE;
# eta): (1, 0) 5.5e-6; 5.8e-6.  (20, 0) 4.2e-4; 7.0e-6.  (1, 0.02) 3.0e-6;
# 3.8e-6.  (20, 0.01) 9.5e-5; 3.0e-5.  With the exact diagonal's change left
# out of the port's agent update (a planted fault) (20, 0) reads 0.82 and
# (20, 0.01) 8.8.  The bounds: (MSE, eta).
F32_TOL = {(1.0, 0.0): (1e-5, 1e-5), (20.0, 0.0): (5e-4, 1e-5),
           (1.0, 0.02): (1e-5, 1e-5), (20.0, 0.01): (1e-4, 1e-4)}


@pytest.mark.parametrize("case", MM_GRID, ids=_mm_id)
@pytest.mark.parametrize("engine", ENGINES)
def test_minimax_run_matches_jax_f32_kernel_path(mm_runs, engine, case):
    (_, _, hj), (_, _, ht) = mm_runs[("f32", engine, *case)]
    assert hj["bytes"] == ht["bytes"]
    assert len(hj["eta"]) == len(ht["eta"])
    mse_tol, eta_tol = F32_TOL[case]
    assert _rel_err(ht["eta"], hj["eta"]) <= eta_tol
    for key in ("train_mse", "test_mse"):
        assert _rel_err(ht[key], hj[key]) <= mse_tol, key


@pytest.mark.parametrize("case", MM_GRID, ids=_mm_id)
@pytest.mark.parametrize("engine", ENGINES)
def test_f32_gap_is_the_predictions_amplified(mm_runs, engine, case):
    """The witness for F32_TOL: the port's last record computed from the
    JAX run's final predictions f (its weights from the same subsample key,
    and the train MSE) is within 1e-5 of the JAX package's, at every
    (alpha, delta), while the two runs' own f differ."""
    (sj, wj, hj), (st, _, _) = mm_runs[("f32", engine, *case)]
    alpha, delta = case
    cfg = ticoa.ICOAConfig(**MM, engine=engine, alpha=alpha, delta=delta,
                           use_kernel=True)
    y = torch.from_numpy(_friedman()[1].astype(np.float32))
    key = k2 = ticoa._first_key(cfg, MM_SEED, "cpu")
    for _ in range(len(hj["eta"]) - 1):     # the last record's key
        key, _, k2 = ticoa._split3(key)
    fj = torch.from_numpy(np.array(sj.f))
    w = ticoa._weights(fj, y, cfg, k2)
    train = float(torch.mean((y - ensemble.combine(w, fj)) ** 2))
    assert _rel_err(train, hj["train_mse"][-1]) <= 1e-5
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(wj)).max()))
    assert float((st.f - fj).abs().max()) > 0.0


@pytest.mark.parametrize("case", MM_GRID, ids=_mm_id)
def test_minimax_engines_agree_within_port(mm_runs, case):
    """The port's three engines agree with each other at the JAX package's
    engine contract (1e-5 relative, float64)."""
    hd = mm_runs[("f64", "dense", *case)][1][2]
    for engine in ("incremental", "fused"):
        he = mm_runs[("f64", engine, *case)][1][2]
        for key in KEYS:
            assert _rel_err(he[key], hd[key]) <= 1e-5, (engine, key)


def test_minimax_run_needs_its_key():
    """At alpha > 1 a sweep draws from its key: none is an error, and the
    run's seed picks the subsamples (another seed, another history)."""
    xc, y, xt, yt = [torch.from_numpy(a) for a in _friedman(n=120)]
    cfg = ticoa.ICOAConfig(n_sweeps=2, alpha=20.0)
    state = ticoa.init_state(TPoly(1, 4), xc, y)
    with pytest.raises(ValueError, match="key"):
        ticoa.sweep(TPoly(1, 4), cfg, state.params, state.f, xc, y)
    h0 = ticoa.run(TPoly(1, 4), cfg, xc, y, xt, yt, seed=0)[2]
    h1 = ticoa.run(TPoly(1, 4), cfg, xc, y, xt, yt, seed=1)[2]
    assert h0["eta"] != h1["eta"]
    assert ticoa.run(TPoly(1, 4), cfg, xc, y, xt, yt, seed=0)[2] == h0
