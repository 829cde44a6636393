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
    p_t, f_t, led_t = ticoa.sweep(fam_t, cfg_t, mid.params, mid.f,
                                  torch.from_numpy(np.array(xc)),
                                  torch.from_numpy(np.array(y)))
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
    with pytest.raises(NotImplementedError, match="A8"):
        ticoa.ICOAConfig(alpha=20.0).validate()
    with pytest.raises(NotImplementedError, match="A8"):
        ticoa.ICOAConfig(delta=0.1).validate()
    with pytest.raises(NotImplementedError, match="A4"):
        ticoa.ICOAConfig(engine="dense").validate()


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
