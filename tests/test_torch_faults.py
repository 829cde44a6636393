"""repro_torch.faults against repro.faults: every local-backend case of
tests/test_faults.py, held to the JAX package.

  * the trace: broadcast outcomes, stragglers and alive windows equal the
    JAX package's draw for draw (float32, and float64 under
    jax.enable_x64, where jax draws its uniforms in float64), pure in
    (seed, round, agent) and independent of a topology's generator;
  * `corrupt` equals jax.random.bits + bitcast_convert_type bit for bit in
    float32 and float64, stays finite, replays, and is the input itself
    when nothing strikes; one row per trial equals the single rows;
  * FaultSpec validation, its JSON key paths, the ExperimentSpec guards
    and the Transport twin, the sweep's engine and delta guards;
  * an inert spec normalises away, and the zero-fault path is bit for bit
    the run without one;
  * replay: the same fault seed gives the same history and bytes;
  * crash zeroes the dead agent's weight and rejoin restores it (against
    the JAX package's records too);
  * batch_fit shares the trace across trials, and trial t equals
    fit(trial_spec(spec, t));
  * ensemble.surviving_weights against the JAX package's, with its three
    edge cases.
The from-spec fits of every fault kind x engine x budget policy are in
tests/test_torch_faults_fit.py.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import ensemble as jensemble
from repro.faults import FaultSpec as JFaultSpec
from repro.faults import trace as jtrace
from repro_torch import api as tapi
from repro_torch import transport as tlib
from repro_torch.agents import PolynomialFamily
from repro_torch.core import ensemble, icoa
from repro_torch.faults import (FaultError, FaultSpec, RoundTrace, alive_at,
                                broadcast_outcome, corrupt, straggles)

_N = 150
_FAULTS = dict(seed=5, drop_rate=0.3, corrupt_rate=0.2, corrupt_bits=4,
               straggle_rate=0.1, max_retries=2, crash=((1, 1, 3),))
FAULTS = FaultSpec(**_FAULTS)
JFAULTS = JFaultSpec(**_FAULTS)
DTYPES = [(torch.float32, False), (torch.float64, True)]


def _spec(faults=FaultSpec(), **solver_kw):
    solver_kw.setdefault("n_sweeps", 4)
    solver_kw.setdefault("eps", 0.0)
    return tapi.ExperimentSpec(
        data=tapi.DataSpec(n_train=_N, n_test=_N, seed=7),
        agent=tapi.AgentSpec(family="polynomial", options=(("degree", 3),)),
        solver=tapi.SolverSpec(**solver_kw), faults=faults)


def _fit(spec, x64=True):
    dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64 if x64 else torch.float32)
    try:
        return tapi.fit(spec, device="cpu")
    finally:
        torch.set_default_dtype(dt)


def _jax_fit(spec, x64=True):
    jspec = japi.spec_from_dict(json.loads(json.dumps(tapi.spec_to_dict(spec))))
    japi.clear_dataset_cache()
    try:
        with jax.enable_x64(x64):
            return japi.fit(jspec)
    finally:
        japi.clear_dataset_cache()


# ------------------------------------------------------------------ traces


@pytest.mark.parametrize("dtype,x64", DTYPES, ids=["f32", "f64"])
def test_trace_matches_jax_draw_for_draw(dtype, x64):
    """Every (round, agent) outcome — delivered, attempts, straggles — is
    the JAX package's, and a repeated draw replays it."""
    with jax.enable_x64(x64):
        for r in range(6):
            delivered, attempts = broadcast_outcome(FAULTS, r, range(7), dtype)
            late = straggles(FAULTS, r, range(7), dtype)
            for i in range(7):
                jd, ja = jtrace.broadcast_outcome(JFAULTS, jnp.int32(r), jnp.int32(i))
                assert (delivered[i], attempts[i]) == (bool(jd), int(ja)), (r, i)
                assert broadcast_outcome(FAULTS, r, i, dtype) == (delivered[i],
                                                                  attempts[i])
                want = bool(jtrace.straggles(JFAULTS, jnp.int32(r), jnp.int32(i)))
                assert straggles(FAULTS, r, i, dtype) == want == late[i]
                assert straggles(FAULTS, r, i, dtype) == want


def test_trace_coordinates_decorrelate():
    def stream(spec, rounds, agent):
        return [broadcast_outcome(spec, r, agent) for r in rounds]

    base = stream(FAULTS, range(12), 0)
    assert stream(FAULTS, range(12), 0) == base
    assert stream(dataclasses.replace(FAULTS, seed=6), range(12), 0) != base
    assert stream(FAULTS, range(12), 1) != base
    assert stream(FAULTS, range(12, 24), 0) != base


def test_trace_ignores_topology_rng():
    before = (broadcast_outcome(FAULTS, 3, 1), straggles(FAULTS, 3, 1))
    for seed in range(4):
        tlib.build_topology("random_graph", 6, options=(("p", 0.8), ("seed", seed)))
    assert (broadcast_outcome(FAULTS, 3, 1), straggles(FAULTS, 3, 1)) == before


def test_alive_at_crash_and_rejoin_windows():
    spec = FaultSpec(crash=((1, 2, 4), (3, 1, -1)))
    jspec = JFaultSpec(crash=((1, 2, 4), (3, 1, -1)))
    expect = {0: (True, True, True, True, True),
              1: (True, True, True, False, True),
              2: (True, False, True, False, True),
              3: (True, False, True, False, True),
              4: (True, True, True, False, True)}
    for r, want in expect.items():
        assert tuple(alive_at(spec, 5, r)) == want, r
        assert tuple(bool(v) for v in np.asarray(
            jtrace.alive_at(jspec, 5, jnp.int32(r)))) == want
    assert all(alive_at(spec, 5, -1))


@pytest.mark.parametrize("dtype,x64", DTYPES, ids=["f32", "f64"])
def test_corrupt_matches_jax_bit_for_bit(dtype, x64):
    """`corrupt`, and the engines' strike (RoundTrace.strike: one round's
    masks of every struck agent drawn at once), equal the JAX package's."""
    np_dt = np.float64 if x64 else np.float32
    spec = FaultSpec(seed=9, corrupt_rate=0.5, corrupt_bits=8)
    jspec = JFaultSpec(seed=9, corrupt_rate=0.5, corrupt_bits=8)
    rng = np.random.default_rng(0)
    struck = 0
    with jax.enable_x64(x64):
        for r in range(4):
            rt = RoundTrace(spec, r, 5, dtype)
            for i in (3, 0, 4, 1, 2):
                x = rng.standard_normal(64).astype(np_dt)
                want = np.asarray(jtrace.corrupt(jspec, jnp.asarray(x),
                                                 jnp.int32(r), jnp.int32(i)))
                got = corrupt(spec, torch.from_numpy(x), r, i).numpy()
                np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
                wire = rt.strike(torch.from_numpy(x), i).numpy()
                np.testing.assert_array_equal(wire.view(np.uint8), want.view(np.uint8))
                assert np.all(np.isfinite(got))
                struck += int(np.any(got != x))
    assert 0 < struck < 20                      # rate 0.5: some rows, not all


def test_corrupt_replays_and_is_a_no_op_when_inert():
    spec = FaultSpec(seed=9, corrupt_rate=1.0, corrupt_bits=8)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(64))
    c1, c2 = corrupt(spec, x, 2, 0), corrupt(spec, x, 2, 0)
    assert torch.equal(c1, c2) and bool(torch.isfinite(c1).all())
    assert bool((c1 != x).any())
    assert corrupt(FaultSpec(), x, 2, 0) is x


def test_corrupt_one_agent_per_trial_equals_single_rows():
    spec = FaultSpec(seed=3, corrupt_rate=0.6, corrupt_bits=20)
    rows = torch.from_numpy(np.random.default_rng(2).standard_normal((6, 40)))
    agents = [0, 3, 1, 4, 2, 3]
    got = corrupt(spec, rows, 1, agents)
    for b, a in enumerate(agents):
        assert torch.equal(got[b], corrupt(spec, rows[b], 1, a))
    shared = corrupt(spec, rows, 1, 3)               # one agent for every trial
    for b in range(6):
        assert torch.equal(shared[b], corrupt(spec, rows[b], 1, 3))


# ------------------------------------------------------- spec and guards


def test_fault_spec_json_roundtrip():
    spec = _spec(faults=FAULTS)
    d = json.loads(json.dumps(tapi.spec_to_dict(spec)))
    back = tapi.spec_from_dict(d)
    assert back == spec and back.faults.crash == ((1, 1, 3),)
    assert json.dumps(japi.spec_to_dict(japi.spec_from_dict(d))) == json.dumps(d)
    d2 = json.loads(json.dumps(tapi.spec_to_dict(_spec())))
    del d2["faults"]
    assert tapi.spec_from_dict(d2).faults.is_inert


def test_spec_from_dict_names_faults_key_paths():
    d = tapi.spec_to_dict(_spec(faults=FAULTS))
    d["faults"]["drop_rat"] = 0.5
    with pytest.raises(tapi.SpecError) as e:
        tapi.spec_from_dict(d)
    assert "spec['faults']" in str(e.value) and "drop_rat" in str(e.value)
    d = tapi.spec_to_dict(_spec(faults=FAULTS))
    d["faults"]["crash"] = [[1, 2]]
    with pytest.raises(tapi.SpecError) as e:
        tapi.spec_from_dict(d)
    assert "spec['faults']['crash'][0]" in str(e.value)
    d["faults"]["crash"] = 7
    with pytest.raises(tapi.SpecError, match=r"spec\['faults'\]\['crash'\]"):
        tapi.spec_from_dict(d)


@pytest.mark.parametrize("kw,field", [
    (dict(drop_rate=1.5), "drop_rate"), (dict(straggle_rate=-0.1), "straggle_rate"),
    (dict(max_retries=-1), "max_retries"), (dict(corrupt_bits=0), "corrupt_bits"),
    (dict(crash=((0, 3, 2),)), "rejoin_round"), (dict(crash=((0, 3),)), "triple"),
    (dict(crash=((-1, 0, 2),)), "agent index"), (dict(crash=((0, -2, 2),)), "down_round"),
])
def test_fault_spec_validation_errors(kw, field):
    """The JAX package's checks, crash triples included; through the spec
    layer they raise a SpecError naming `faults`."""
    with pytest.raises(FaultError, match=field):
        FaultSpec(**kw).validate()
    with pytest.raises(ValueError, match=field):      # the JAX FaultError
        JFaultSpec(**kw).validate()
    with pytest.raises(tapi.SpecError, match="faults"):
        _spec(faults=FaultSpec(**kw)).validate()
    assert tapi.FaultError is FaultError


def test_experiment_spec_guards_fault_combinations():
    with pytest.raises(tapi.SpecError, match="engine"):
        _spec(faults=FAULTS, engine="dense").validate()
    with pytest.raises(tapi.SpecError, match="solver"):
        dataclasses.replace(_spec(faults=FAULTS),
                            solver=tapi.SolverSpec(name="averaging")).validate()
    with pytest.raises(tapi.SpecError, match="delta"):
        _spec(faults=FAULTS, delta=0.01).validate()
    bad = FaultSpec(crash=((9, 0, -1),))
    with pytest.raises(tapi.SpecError, match="agent 9"):
        _spec(faults=bad).validate()
    tp = tlib.Transport(topology=tlib.build_topology("full", 5),
                        codec=tlib.build_codec("exact_f64"), faults=bad)
    with pytest.raises(tlib.TransportError, match="agent 9"):
        tp.validate_for(5)
    # delta > 0 with drops alone is fine (no masked weights needed)
    _spec(faults=FaultSpec(drop_rate=0.2), delta=0.01).validate()


def _core_run(faults, **cfg):
    xtr, ytr, _, _ = tapi.DataSpec(n_train=64, n_test=8).build("cpu")[:4]
    fam = PolynomialFamily(n_cols=1, degree=2)
    tp = tlib.Transport(topology=tlib.build_topology("full", 5),
                        codec=tlib.build_codec("exact_f64"), faults=faults)
    conf = icoa.ICOAConfig(n_sweeps=1, transport=tp, **cfg)
    st = icoa.init_state(fam, xtr, ytr)
    return icoa.sweep(fam, conf, st.params, st.f, xtr, ytr, ledger=None)


def test_core_sweep_rejects_dense_engine_and_crash_with_delta():
    with pytest.raises(ValueError, match="incremental"):
        _core_run(FaultSpec(drop_rate=0.5), engine="dense")
    with pytest.raises(ValueError, match="delta"):
        _core_run(FaultSpec(crash=((0, 0, 1),)), delta=0.01, alpha=2.0)
    _core_run(FaultSpec(drop_rate=0.5), engine="fused")          # runs


def test_inert_fault_spec_normalises_away():
    tp = tlib.Transport(topology=tlib.build_topology("full", 5),
                        codec=tlib.build_codec("exact_f64"),
                        faults=FaultSpec(seed=123))
    assert tp.faults is None
    tp2 = dataclasses.replace(tp)
    assert tp == tp2 and hash(tp) == hash(tp2)
    assert _spec(faults=FaultSpec(seed=123)).resolved_transport().faults is None
    assert _spec(faults=FAULTS).resolved_transport().faults == FAULTS


@pytest.mark.parametrize("engine", ["incremental", "fused"])
def test_zero_fault_path_is_bit_identical(engine):
    ra = _fit(_spec(engine=engine))
    rb = _fit(_spec(faults=FaultSpec(seed=99), engine=engine))
    assert ra.history.as_dict() == rb.history.as_dict()
    assert torch.equal(ra.weights, rb.weights) and torch.equal(ra.f, rb.f)


@pytest.mark.parametrize("engine", ["incremental", "fused"])
def test_same_fault_seed_replays_identical_history_and_bytes(engine):
    ra = _fit(_spec(faults=FAULTS, engine=engine))
    rb = _fit(_spec(faults=FAULTS, engine=engine))
    assert ra.history.as_dict() == rb.history.as_dict()
    assert torch.equal(ra.weights, rb.weights)
    rc = _fit(_spec(faults=dataclasses.replace(FAULTS, seed=11), engine=engine))
    assert rc.history.bytes_transmitted != ra.history.bytes_transmitted


def test_retries_and_skips_move_the_ledger_as_the_jax_package_charges():
    """Under drops with retries a sweep can charge more than the clean one
    (retransmissions) or less (skipped stragglers and dead agents); the
    port's ledger equals the JAX package's sweep for sweep either way, and
    retrying on a drop never charges less than giving up at once."""
    clean = _fit(_spec()).history.bytes_transmitted[1:]
    assert len(set(clean)) == 1
    faulted = _fit(_spec(faults=FAULTS, n_sweeps=6))
    assert faulted.history.bytes_transmitted == _jax_fit(
        _spec(faults=FAULTS, n_sweeps=6)).history.bytes_transmitted
    assert max(faulted.history.bytes_transmitted[1:]) > clean[0]
    drops = FaultSpec(seed=5, drop_rate=0.4, max_retries=3)
    by_retry = sum(_fit(_spec(faults=drops)).history.bytes_transmitted)
    by_skip = sum(_fit(_spec(faults=dataclasses.replace(
        drops, max_retries=0))).history.bytes_transmitted)
    assert by_retry > by_skip


# ------------------------------------------------------- crash and rejoin


def test_permanent_crash_zeroes_the_dead_agents_weight():
    spec = _spec(faults=FaultSpec(crash=((2, 0, -1),)))
    res = _fit(spec)
    w = res.weights.numpy()
    assert w[2] == 0.0 and abs(w.sum() - 1.0) < 1e-12
    jres = _jax_fit(spec)
    np.testing.assert_allclose(w, np.asarray(jres.weights), rtol=1e-9, atol=1e-12)
    assert np.asarray(jres.weights)[2] == 0.0


def test_rejoined_agent_recovers_weight():
    down = _fit(_spec(faults=FaultSpec(crash=((1, 1, -1),)), n_sweeps=5))
    back = _fit(_spec(faults=FaultSpec(crash=((1, 1, 3),)), n_sweeps=5))
    assert down.weights[1].item() == 0.0
    assert back.weights[1].item() != 0.0
    assert abs(down.weights.sum().item() - 1.0) < 1e-12


# -------------------------------------------------------------- batches


@pytest.mark.parametrize("engine", ["incremental", "fused"])
def test_batch_fit_shares_the_trace(engine):
    """Every trial sees the same trace (pure in seed, round, agent), so the
    byte histories agree trial to trial and equal the JAX package's batch;
    trial t is fit(trial_spec(spec, t))."""
    spec = _spec(faults=FAULTS, n_sweeps=3, engine=engine)
    dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        rs = tapi.batch_fit(spec, 3, device="cpu")
    finally:
        torch.set_default_dtype(dt)
    b0 = rs[0].history.bytes_transmitted
    assert all(r.history.bytes_transmitted == b0 for r in rs)
    jspec = japi.spec_from_dict(json.loads(json.dumps(tapi.spec_to_dict(spec))))
    japi.clear_dataset_cache()
    try:
        with jax.enable_x64(True):
            jrs = japi.batch_fit(jspec, 3)
    finally:
        japi.clear_dataset_cache()
    for t in range(3):
        got, want = rs[t].history, jrs.results[t].history
        assert got.bytes_transmitted == want.bytes_transmitted
        for key in ("train_mse", "test_mse", "eta"):
            np.testing.assert_allclose(getattr(got, key), getattr(want, key),
                                       rtol=1e-10, err_msg=key)
        one = _fit(tapi.trial_spec(spec, t))
        np.testing.assert_allclose(got.eta, one.history.eta, rtol=1e-12)


# ------------------------------------------------------ surviving weights


def _spd(d, seed):
    r = np.random.default_rng(seed).standard_normal((d, 40))
    return r @ r.T / 40


@pytest.mark.parametrize("alive", [
    (True, False, True, True, False), (True,) * 5, (False, False, True, False, False),
    (False,) * 5], ids=["two_dead", "all_alive", "one_survivor", "none"])
def test_surviving_weights_match_jax(alive):
    a = _spd(5, 0)
    got = ensemble.surviving_weights(torch.from_numpy(a), torch.tensor(alive)).numpy()
    with jax.enable_x64(True):
        want = np.asarray(jensemble.surviving_weights(jnp.asarray(a),
                                                      jnp.asarray(alive)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    dead = ~np.asarray(alive)
    if any(alive):
        assert np.all(got[dead] == 0.0) and abs(got.sum() - 1.0) < 1e-12
    if sum(alive) == 1:
        assert np.array_equal(got, np.asarray(alive, np.float64))   # one-hot
    if not any(alive):
        assert np.array_equal(got, np.full(5, 0.2))                  # uniform


def test_surviving_weights_degenerate_solve_falls_back_to_uniform():
    """A solution summing to zero over the survivors (a matrix with an
    infinite entry among them, as a corrupted one): uniform over them."""
    a = _spd(4, 1)
    a[0, 0] = np.inf
    alive = (True, True, False, False)
    got = ensemble.surviving_weights(torch.from_numpy(a), torch.tensor(alive)).numpy()
    with jax.enable_x64(True):
        want = np.asarray(jensemble.surviving_weights(jnp.asarray(a),
                                                      jnp.asarray(alive)))
    np.testing.assert_array_equal(got, want)


def test_surviving_weights_batched_equal_single():
    a = np.stack([_spd(5, s) for s in range(3)])
    alive = torch.tensor([[True, False, True, True, True],
                          [False, False, True, False, False],
                          [True] * 5])
    got = ensemble.surviving_weights(torch.from_numpy(a), alive)
    for b in range(3):
        one = ensemble.surviving_weights(torch.from_numpy(a[b]), alive[b])
        torch.testing.assert_close(got[b], one, rtol=1e-13, atol=1e-15)
