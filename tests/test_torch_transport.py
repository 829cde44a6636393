"""repro_torch.transport against repro.transport, and the budgeted solver.

  * the topology tables (adjacency, hops, ecc, bcast_tx) of every builder at
    D in {1, 2, 5, 8, 100} equal the JAX package's, or both raise the
    disconnection error;
  * every codec's roundtrip, encode / decode and nbytes equal the JAX
    package's compiled ones bit for bit, float32 and float64, including
    constant rows, single values, k >= m and ties in |x|; the relays (one
    row, a matrix, per-trial hops, straight through) too;
  * the ledger's budget arithmetic and the policies' gates; greedy_order
    equal, and per trial for a batched CovState;
  * the per-trial agent index of covstate and of the batched sweep refs:
    slice b equals the shared-index call on agent i[b], bit for bit;
  * budgeted fits (both policies, full and star, alpha 1 and 20, the two
    engines that gate) from the spec at 1e-10 (float64) with the bytes
    equal; batch_fit's per-trial ledgers equal repro.api.batch_fit's and
    diverge on star under greedy_eta; float32 and the kernels' plain path;
  * the refit baseline through a lossy codec; spec errors; a Result with a
    transport spec and a ledger through the checkpoint files; api.sweep
    over the transport's axes.

float32: the codecs are held bit for bit; budgeted fp32 runs of the
kernels' plain path against the JAX package's fp32 run within F32_TOL
(1e-5, the alpha = 1 contract of tests/test_torch_icoa.py) and the same
ledgers.  The fits over topology x codec x engine are in
test_torch_transport_fit.py.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import transport as jtr
from repro.core import covstate as jcov
from repro_torch import api as tapi
from repro_torch import transport as ttr
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import covstate as tcov
from repro_torch.kernels.sweep import ref as sweep_ref

F32_TOL = 1e-5
TOPOLOGIES = [("full", ()), ("ring", ()), ("star", ()),
              ("random_graph", (("p", 0.8), ("seed", 3)))]
CODECS = [("exact_f64", ()), ("exact_f32", ()), ("exact_bf16", ()),
          ("int8_affine", ()), ("topk_sparse", (("k", 64),)),
          ("topk_sparse", (("k", 3),))]


def _dt(x64):
    return (np.float64, torch.float64) if x64 else (np.float32, torch.float32)


# ------------------------------------------------------------- topologies

@pytest.mark.parametrize("d", [1, 2, 5, 8, 100])
@pytest.mark.parametrize("name,opts", TOPOLOGIES, ids=lambda v: str(v))
def test_topology_tables_match_jax(name, opts, d):
    try:
        want = jtr.build_topology(name, d, opts)
    except jtr.TransportError as e:
        with pytest.raises(ttr.TransportError, match="disconnected"):
            ttr.build_topology(name, d, opts)
        assert "disconnected" in str(e)
        return
    got = ttr.build_topology(name, d, opts)
    for field in ("adjacency", "hops", "ecc", "bcast_tx"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.max_ecc == want.max_ecc and got.is_complete == want.is_complete


def test_topology_errors_match_jax():
    for args in (("random_graph", 8, (("p", 0.05), ("seed", 1))),
                 ("random_graph", 4, (("p", 1.5),)), ("mesh", 4, ()),
                 ("ring", 4, (("p", 0.5),)), ("full", 0, ())):
        with pytest.raises(jtr.TransportError) as je:
            jtr.build_topology(*args)
        with pytest.raises(ttr.TransportError) as te:
            ttr.build_topology(*args)
        assert str(te.value).split(";")[0] == str(je.value).split(";")[0]
    # the deployment prices of the ring, star and random graph at D = 100
    ring = ttr.build_topology("ring", 100)
    assert ring.max_ecc == 50 and sum(ring.bcast_tx) == 9800
    assert sum(ttr.build_topology("star", 100).bcast_tx) == 199
    rg = ttr.build_topology("random_graph", 100, (("p", 0.8), ("seed", 3)))
    assert sum(rg.bcast_tx) == 353


# ----------------------------------------------------------------- codecs

def _payloads(dt):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((6, 300)) * rng.random((6, 1)) * 10).astype(dt)
    x[1] = 3.25                                   # a constant row
    x[2, :9] = 0.5                                # ties in |x|
    x[2, 20:40] = -0.5
    x[3, ::2] = x[3, 1::2]                        # pairs of equal values
    return [x, x[:, :2], x[:1, :1], x[0, :1], x[4]]   # rows, k >= m, one value


def _leaves(payload):
    if isinstance(payload, dict):
        return {k: v for k, v in payload.items() if k != "length"}
    return {"x": payload}


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("name,opts", CODECS, ids=lambda v: str(v))
def test_codec_matches_jax_bit_for_bit(name, opts, x64):
    np_dt, t_dt = _dt(x64)
    jc, tc = jtr.build_codec(name, opts), ttr.build_codec(name, opts)
    with jax.enable_x64(x64):
        for n in (1, 7, 64, 300, 262144):
            assert tc.nbytes(n) == jc.nbytes(n)
        for t, j in ((torch.float32, jnp.float32), (torch.float64, jnp.float64),
                     (torch.bfloat16, jnp.bfloat16)):
            assert tc.is_identity_for(t) == jc.is_identity_for(j)
        for x in _payloads(np_dt):
            tx = torch.from_numpy(x)
            want = np.asarray(jax.jit(jc.roundtrip)(jnp.asarray(x)))
            got = tc.roundtrip(tx)
            assert got.dtype == t_dt
            np.testing.assert_array_equal(got.numpy(), want)
            jpay = jax.jit(jc.encode)(jnp.asarray(x)) if name != "topk_sparse" \
                else jc.encode(jnp.asarray(x))
            tpay = tc.encode(tx)
            for key, leaf in _leaves(jpay).items():
                np.testing.assert_array_equal(
                    _leaves(tpay)[key].float().numpy()
                    if _leaves(tpay)[key].dtype == torch.bfloat16
                    else _leaves(tpay)[key].numpy(),
                    np.asarray(leaf, np.float32) if leaf.dtype == jnp.bfloat16
                    else np.asarray(leaf), err_msg=key)
            dec = jax.jit(jc.decode)(jpay) if name != "topk_sparse" \
                else jc.decode(jpay)
            got_dec = tc.decode(tpay)
            assert str(got_dec.dtype).split(".")[-1] == str(dec.dtype)
            np.testing.assert_array_equal(got_dec.double().numpy(),
                                          np.asarray(dec).astype(np.float64))


def test_int8_constant_rows_and_single_values_pass_exactly():
    tc = ttr.build_codec("int8_affine")
    for dt in (torch.float32, torch.float64):
        x = torch.tensor([[2.5] * 7, [-1.0] * 7], dtype=dt)
        assert torch.equal(tc.roundtrip(x), x)
        v = torch.tensor([0.1234567], dtype=dt)
        assert torch.equal(tc.roundtrip(v), v)
    k = ttr.build_codec("topk_sparse", (("k", 2),))
    got = k.encode(torch.tensor([1.0, -3.0, 3.0, 2.0, -3.0]))
    assert got["indices"].tolist() == [1, 2] and got["indices"].dtype == torch.int32
    assert got["values"].dtype == torch.float32


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("codec", ["int8_affine", "topk_sparse", "exact_bf16"])
def test_relays_match_jax(codec, x64):
    np_dt, _ = _dt(x64)
    x = _payloads(np_dt)[0][:5]
    with jax.enable_x64(x64):
        jt = jtr.Transport(topology=jtr.build_topology("ring", 5),
                           codec=jtr.build_codec(codec, ()))
        tt = ttr.Transport(topology=ttr.build_topology("ring", 5),
                           codec=ttr.build_codec(codec))
        tx, jx = torch.from_numpy(x), jnp.asarray(x)
        np.testing.assert_array_equal(tt.relay_rows(tx).numpy(),
                                      np.asarray(jax.jit(jt.relay_rows)(jx)))
        for i in range(5):
            np.testing.assert_array_equal(
                tt.relay_row(tx[i], i).numpy(),
                np.asarray(jax.jit(jt.relay_row, static_argnums=1)(jx[i], i)))
        np.testing.assert_array_equal(tt.relay_scalars(tx[:, 0]).numpy(),
                                      np.asarray(jax.jit(jt.relay_scalars)(jx[:, 0])))
        # straight through, hop by hop: the value and the gradient
        w = np.random.default_rng(1).standard_normal(x.shape).astype(np_dt)

        def jobj(v):
            return jnp.sum(jt.relay_rows_st(v) ** 2 * jnp.asarray(w))

        jval, jgrad = jax.jit(jax.value_and_grad(jobj))(jx)
        tv = tx.clone().requires_grad_(True)
        tval = torch.sum(tt.relay_rows_st(tv) ** 2 * torch.from_numpy(w))
        tval.backward()
        np.testing.assert_array_equal(
            tt.relay_rows_st(tx).numpy(), np.asarray(jax.jit(jt.relay_rows_st)(jx)))
        np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jgrad),
                                   rtol=1e-6 if not x64 else 1e-13)
        np.testing.assert_allclose(float(tval.detach()), float(jval),
                                   rtol=1e-6 if not x64 else 1e-13)
    # per-trial hops: trial b's row relayed from its own agent
    agents = torch.tensor([0, 3, 2, 1, 4])
    got = tt.relay_row(tx, agents)
    for b in range(5):
        assert torch.equal(got[b], tt.relay_row(tx[b], int(agents[b])))
    assert torch.equal(tt.relay_scalar(tx[:, 0], agents),
                       torch.stack([tt.relay_scalar(tx[b, 0], int(agents[b]))
                                    for b in range(5)]))


# --------------------------------------------------------- ledger, policy

def test_ledger_budget_arithmetic():
    led = ttr.Ledger().charge(1000)
    assert led.affords(500, 1500.9) and not led.affords(501, 1500.9)
    assert led.charge_if(False, 7) == led and led.charge_if(True, 7).spent == 1007
    trials = ttr.TrialLedgers.empty(3).charge([100, 200, 300])
    assert trials.affords(250, 450) == (True, True, False)
    assert trials.charge_if((True, False, True), 10).spent == (110, 200, 310)
    assert trials.charge(torch.tensor([1, 2, 3])).spent == (101, 202, 303)
    # the deployment ring's int8 sweep overflows int32; the host ledger does not
    ring = ttr.Transport(topology=ttr.build_topology("ring", 100),
                         codec=ttr.build_codec("int8_affine"))
    cost = ttr.icoa_sweep_cost(ring, 262144, split=False, row_wise=True)
    assert cost == 5_138_179_200 > 2**31
    star = dataclasses.replace(ring, topology=ttr.build_topology("star", 100))
    assert ttr.icoa_sweep_cost(star, 262144, False, True) == 104_336_496
    rg = dataclasses.replace(ring, topology=ttr.build_topology(
        "random_graph", 100, (("p", 0.8), ("seed", 3))))
    assert ttr.icoa_sweep_cost(rg, 262144, False, True) == 185_079_312
    for tt in (ring, star, rg):
        jt = jtr.Transport(topology=jtr.build_topology(tt.topology.name, 100,
                                                       (("p", 0.8), ("seed", 3))
                                                       if tt.topology.name ==
                                                       "random_graph" else ()),
                           codec=jtr.build_codec("int8_affine"))
        assert tt.broadcast_costs(300, True) == tuple(
            int(c) for c in jt.broadcast_costs(300, True))


def test_transport_validation_matches_jax():
    topo, codec = ttr.build_topology("full", 3), ttr.build_codec("exact_f64")
    for kw in (dict(policy="fastest"), dict(byte_budget=0.0),
               dict(byte_budget=float("inf"))):
        with pytest.raises(ttr.TransportError):
            ttr.Transport(topology=topo, codec=codec, **kw)
        with pytest.raises(jtr.TransportError):
            jtr.Transport(topology=jtr.build_topology("full", 3),
                          codec=jtr.build_codec("exact_f64"), **kw)
    with pytest.raises(ValueError, match="dense engine"):
        ttr.require_budget_engine(ttr.Transport(topology=topo, codec=codec,
                                                byte_budget=10.0), "dense")


def _covstates(x64, alpha_split):
    np_dt, t_dt = _dt(x64)
    rng = np.random.default_rng(7)
    r = rng.standard_normal((4, 7, 120)).astype(np_dt)
    exact = (np.sum(r * r, axis=-1) / 120 * 1.1) if alpha_split else None
    t_states = tcov.build(torch.from_numpy(r),
                          None if exact is None else torch.from_numpy(exact))
    return r, exact, t_states


@pytest.mark.parametrize("split", [False, True], ids=["alpha1", "split"])
def test_greedy_order_matches_jax(split):
    r, exact, tstate = _covstates(True, split)
    step0 = torch.tensor(np.sqrt(120.0), dtype=torch.float64)
    order, scores = ttr.greedy_order(tstate, step0)
    with jax.enable_x64(True):
        for b in range(r.shape[0]):
            js = jcov.build(jnp.asarray(r[b]), None if exact is None
                            else jnp.asarray(exact[b]))
            jorder, jscores = jtr.greedy_order(js, jnp.sqrt(120.0))
            assert order[b].tolist() == np.asarray(jorder).tolist()
            np.testing.assert_allclose(scores[b].numpy(), np.asarray(jscores),
                                       rtol=1e-12)
            one = tcov.CovState(*(t[b] for t in tstate))
            o1, s1 = ttr.greedy_order(one, step0)
            assert o1.tolist() == order[b].tolist()
    # ties keep the lower agent first (a stable sort of -score)
    same = tcov.CovState(*(t[0].expand(3, *t[0].shape) if t.dim() == 1 else
                           t[0].expand(3, *t.shape[1:]).clone()
                           for t in (tstate.r_sub[:1].expand(3, 7, 120),
                                     tstate.a0[:1], tstate.m_inv[:1],
                                     tstate.s[:1], tstate.eta_tilde[:1])))
    assert ttr.greedy_order(same, step0)[0].tolist() == [order[0].tolist()] * 3


def test_budget_setup_and_gates_match_jax():
    """The sweep-start state and every gate of a sweep, against the JAX
    package's budget_setup / gate_broadcast on the same CovState."""
    r, _, tstate = _covstates(True, False)
    one = tcov.CovState(*(t[0] for t in tstate))
    for topo in ("full", "star", "ring"):
        for policy in ("greedy_eta", "truncate"):
            for frac in (0.3, 0.75, 1.4):
                price = None
                with jax.enable_x64(True):
                    jt = jtr.Transport(topology=jtr.build_topology(topo, 7),
                                       codec=jtr.build_codec("exact_f32"))
                    price = jtr.icoa_sweep_cost(jt, 120, False, True)
                    jt = dataclasses.replace(jt, byte_budget=frac * price,
                                           policy=policy)
                    js = jcov.build(jnp.asarray(r[0]))
                    live, order, bcosts, led = jtr.budget_setup(
                        jt, js, jtr.Ledger.empty(), 120, False,
                        jnp.sqrt(120.0))
                    jcans = []
                    for slot in range(7):
                        can, led = jtr.gate_broadcast(led, live, bcosts,
                                                      order[slot],
                                                      jt.byte_budget)
                        jcans.append(bool(can))
                    jspent = int(led.spent)
                tt = ttr.Transport(topology=ttr.build_topology(topo, 7),
                                   codec=ttr.build_codec("exact_f32"),
                                   byte_budget=frac * price, policy=policy)
                tlive, torder, tb, tled = ttr.budget_setup(
                    tt, one, ttr.Ledger(), 120, False,
                    torch.tensor(np.sqrt(120.0), dtype=torch.float64))
                assert tlive == bool(live) and list(tb) == np.asarray(bcosts).tolist()
                assert list(torder) == np.asarray(order).tolist()
                cans, tled = ttr.gate_schedule(tled, tlive, tb, torder,
                                               tt.byte_budget)
                assert cans == jcans and tled.spent == jspent


# ------------------------------------------------------- per-trial agents

def test_covstate_per_trial_agent_equals_shared_agent():
    r, exact, st = _covstates(True, True)
    agents = torch.tensor([3, 0, 6, 3])
    rng = np.random.default_rng(2)
    u = torch.from_numpy(rng.standard_normal((4, 7)))
    uk = torch.from_numpy(rng.standard_normal((4, 5, 7)))
    delta = torch.from_numpy(rng.standard_normal((4, 120)))
    ddiag = torch.from_numpy(rng.standard_normal(4))
    got = dict(probe=tcov.eta_probe(st, agents, u),
               sched=tcov.eta_probe(st, agents, uk),
               sp=tcov.s_probe(st, agents, uk),
               robust=tcov.robust_eta_probe(st, agents, u, 0.01, 20, 0.05),
               vec=tcov.row_update_vector(st, agents, delta),
               vecd=tcov.row_update_vector(st, agents, delta, ddiag=ddiag),
               inv=tcov.apply_inverse_update(st, agents, u))
    for b in range(4):
        i = int(agents[b])
        want = dict(probe=tcov.eta_probe(st, i, u), sched=tcov.eta_probe(st, i, uk),
                    sp=tcov.s_probe(st, i, uk),
                    robust=tcov.robust_eta_probe(st, i, u, 0.01, 20, 0.05),
                    vec=tcov.row_update_vector(st, i, delta),
                    vecd=tcov.row_update_vector(st, i, delta, ddiag=ddiag),
                    inv=tcov.apply_inverse_update(st, i, u))
        for key, w in want.items():
            g = got[key]
            if isinstance(w, tuple):
                for gg, ww in zip(g, w):
                    assert torch.equal(gg[b], ww[b]), key
            else:
                assert torch.equal(g[b], w[b]), key


def test_batched_sweep_refs_take_per_trial_agents():
    """The batched plain versions of B6 and B8 with one agent per trial:
    slice b equals the shared-agent call on agent i[b], bit for bit — in
    particular a trial whose can_tx is false keeps m_inv and s."""
    _, _, st = _covstates(False, False)
    r = st.r_sub
    agents = torch.tensor([5, 1, 1, 6])
    steps = torch.tensor([2.0, 1.0, 0.5, 0.25])
    eta = st.eta_tilde
    delta = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 120))
                             .astype(np.float32))
    can = torch.tensor([True, False, True, True])
    probe = sweep_ref.probe_sweep_batched_ref(r, st.m_inv, st.s, eta, agents, steps)
    commit = sweep_ref.commit_sweep_batched_ref(r, st.m_inv, st.s, eta, agents,
                                                delta, 1.0, 0.0, eta, can)
    for b in range(4):
        i = int(agents[b])
        p1 = sweep_ref.probe_sweep_batched_ref(r, st.m_inv, st.s, eta, i, steps)
        c1 = sweep_ref.commit_sweep_batched_ref(r, st.m_inv, st.s, eta, i,
                                                delta, 1.0, 0.0, eta, can)
        for g, w in zip(probe + commit, p1 + c1):
            assert torch.equal(g[b], w[b])
    assert not bool(commit[3][1])
    assert torch.equal(commit[0][1], st.m_inv[1]) and torch.equal(commit[1][1], st.s[1])


# ---------------------------------------------------------- budgeted fits

def _fit_pair(d, x64=True):
    dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64 if x64 else torch.float32)
    try:
        tres = tapi.fit(tapi.spec_from_dict(d), device="cpu")
    finally:
        torch.set_default_dtype(dt)
    japi.clear_dataset_cache()
    try:
        with jax.enable_x64(x64):
            jres = japi.fit(japi.spec_from_dict(d))
    finally:
        japi.clear_dataset_cache()
    return tres, jres


def _same(tres, jres, rtol):
    for key in ("train_mse", "test_mse", "eta"):
        np.testing.assert_allclose(getattr(tres.history, key),
                                   getattr(jres.history, key), rtol=rtol,
                                   err_msg=key)
    assert tres.history.bytes_transmitted == jres.history.bytes_transmitted


def _budget_spec(topo, alpha, policy, engine, frac=1.6, **solver):
    tp = ttr.Transport(topology=ttr.build_topology(topo, 5),
                       codec=ttr.build_codec("int8_affine"))
    m = 300 if alpha == 1.0 else -(-300 // int(alpha))
    price = ttr.icoa_sweep_cost(tp, m, split=alpha > 1.0, row_wise=True)
    return {"data": {"n_train": 300, "n_test": 200, "seed": 3},
            "solver": {"n_sweeps": 3, "engine": engine, "alpha": alpha,
                       "eps": 0.0, **solver},
            "transport": {"topology": topo, "codec": "int8_affine",
                          "byte_budget": frac * price, "policy": policy},
            "seed": 2}


@pytest.mark.parametrize("engine", ["incremental", "fused"])
@pytest.mark.parametrize("policy", ["greedy_eta", "truncate"])
@pytest.mark.parametrize("alpha", [1.0, 20.0])
@pytest.mark.parametrize("topo", ["full", "star"])
def test_budgeted_fit_matches_jax_f64(topo, alpha, policy, engine):
    d = _budget_spec(topo, alpha, policy, engine)
    tres, jres = _fit_pair(d)
    _same(tres, jres, 1e-10)
    spent = sum(tres.history.bytes_transmitted)
    assert spent <= d["transport"]["byte_budget"]
    assert tres.history.bytes_transmitted[-1] < tres.history.bytes_transmitted[1]


@pytest.mark.parametrize("engine", ["incremental", "fused"])
def test_budgeted_fit_kernel_path_f32(engine):
    """float32 with use_kernel (the kernels' plain versions on the CPU):
    within F32_TOL of the JAX package's fp32 run, the same ledger."""
    d = _budget_spec("star", 1.0, "greedy_eta", engine, use_kernel=True)
    tres, jres = _fit_pair(d, x64=False)
    _same(tres, jres, F32_TOL)


def _batch_pair(d, trials):
    dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        trs = tapi.batch_fit(tapi.spec_from_dict(d), trials, device="cpu")
    finally:
        torch.set_default_dtype(dt)
    japi.clear_dataset_cache()
    try:
        with jax.enable_x64(True):
            jrs = japi.batch_fit(japi.spec_from_dict(d), trials)
    finally:
        japi.clear_dataset_cache()
    return trs, jrs


@pytest.mark.parametrize("engine", ["incremental", "fused"])
def test_batch_fit_ledgers_diverge_as_jax_on_star(engine):
    d = _budget_spec("star", 1.0, "greedy_eta", engine, frac=0.75)
    d["transport"]["codec"] = "exact_f64"
    d["transport"]["byte_budget"] = 0.75 * 2 * 300 * 8 * 9
    trs, jrs = _batch_pair(d, 6)
    ledgers = [r.history.bytes_transmitted for r in trs]
    assert ledgers == [r.history.bytes_transmitted for r in jrs]
    assert len({tuple(b) for b in ledgers}) > 1
    for a, b in zip(trs, jrs):
        _same(a, b, 1e-10)
    with pytest.raises(ValueError, match="diverge"):
        trs.cumulative_bytes()


@pytest.mark.parametrize("engine,delta", [("incremental", 0.0),
                                          ("incremental", 0.01),
                                          ("fused", 0.0)])
def test_batch_fit_budgeted_split_matches_jax(engine, delta):
    """A budgeted greedy_eta batch at alpha = 20 (the Sec 4.1 split, and
    the robust probes at delta > 0) with one agent per trial: every trial
    against repro.api.batch_fit's at 1e-10, the ledgers equal."""
    d = _budget_spec("star", 20.0, "greedy_eta", engine, frac=0.6,
                     minimax_steps=40, delta=delta)
    d["solver"]["n_sweeps"] = 2
    trs, jrs = _batch_pair(d, 4)
    for a, b in zip(trs, jrs):
        _same(a, b, 1e-10)


def test_batch_fit_per_trial_agents_on_the_kernel_path():
    """use_kernel on the CPU: the batched probe and commit (plain versions)
    with one agent per trial; every trial's ledger equals its float64
    twin's, and each trial equals its own fit within the fp32 contract."""
    d = _budget_spec("star", 1.0, "greedy_eta", "fused", frac=0.75,
                     use_kernel=True)
    d["transport"]["codec"] = "exact_f64"
    d["transport"]["byte_budget"] = 0.75 * 2 * 300 * 8 * 9
    spec = tapi.spec_from_dict(d)
    rs = tapi.batch_fit(spec, 4, device="cpu")
    for t, res in enumerate(rs):
        one = tapi.fit(tapi.trial_spec(spec, t), device="cpu")
        assert res.history.bytes_transmitted == one.history.bytes_transmitted
        np.testing.assert_allclose(res.history.eta, one.history.eta, rtol=3e-5)


# --------------------------------------------------- baselines, specs, io

@pytest.mark.parametrize("codec", [("int8_affine", ()), ("topk_sparse", (("k", 40),))])
def test_refit_baseline_through_a_lossy_codec(codec):
    d = {"data": {"n_train": 200, "n_test": 100, "seed": 4},
         "solver": {"name": "residual_refitting", "n_sweeps": 3},
         "transport": {"codec": codec[0], "codec_options": codec[1]}}
    tres, jres = _fit_pair(d)
    _same(tres, jres, 1e-10)
    trs, jrs = _batch_pair(d, 2)
    for a, b in zip(trs, jrs):
        _same(a, b, 1e-10)
    plain = dict(d, transport={})
    assert tapi.fit(tapi.spec_from_dict(plain), device="cpu").history.train_mse \
        != tres.history.train_mse


def test_spec_errors_match_jax():
    bad = [
        {"solver": {"engine": "dense"}, "transport": {"byte_budget": 1e5}},
        {"solver": {"name": "averaging"}, "transport": {"byte_budget": 1e5}},
        {"transport": {"topology": "ring", "topology_options": [["p", 0.3]]}},
        {"transport": {"codec": "topk_sparse", "codec_options": [["q", 3]]}},
        {"transport": {"policy": "random"}},
        {"transport": {"byte_budget": -1.0}},
        {"transport": {"topology": "random_graph",
                       "topology_options": [["p", 0.01], ["seed", 2]]}},
        {"transport": {"codec": "topk_sparse", "codec_options": [["k", 0]]}},
    ]
    for d in bad:
        with pytest.raises(japi.SpecError):
            js = japi.spec_from_dict(d)
            js.validate()
            js.resolved_transport()
        with pytest.raises(tapi.SpecError):
            ts = tapi.spec_from_dict(d)
            ts.validate()
            ts.resolved_transport()
    with pytest.raises(ValueError, match="dense engine"):
        from repro_torch.core import icoa
        tp = ttr.Transport(topology=ttr.build_topology("full", 5),
                           codec=ttr.build_codec("exact_f64"), byte_budget=1e5)
        x = torch.zeros(5, 10, 1)
        icoa.sweep(tapi.AgentSpec().resolve(1), icoa.ICOAConfig(
            engine="dense", transport=tp), torch.zeros(5, 5), torch.zeros(5, 10),
            x, torch.zeros(10))


def test_transport_result_and_ledger_round_trip(tmp_path):
    d = _budget_spec("random_graph", 1.0, "truncate", "fused")
    d["transport"]["topology_options"] = [["p", 0.8], ["seed", 3]]
    d["transport"]["codec"] = "topk_sparse"
    d["transport"]["codec_options"] = [["k", 50]]
    d["transport"]["byte_budget"] = 1e5
    tres = tapi.fit(tapi.spec_from_dict(d), device="cpu")
    tres.save(str(tmp_path / "port"))
    japi.clear_dataset_cache()
    jback = japi.load(str(tmp_path / "port"))
    assert json.loads(json.dumps(japi.spec_to_dict(jback.spec))) == \
        json.loads(json.dumps(tapi.spec_to_dict(tres.spec)))
    assert jback.history.bytes_transmitted == tres.history.bytes_transmitted
    back = tapi.load(str(tmp_path / "port"), device="cpu", with_data=False)
    assert back.spec == tres.spec and back.spec.resolved_transport() == \
        tres.spec.resolved_transport()
    japi.clear_dataset_cache()
    # a ledger's integer spend, written by either package
    led = ttr.Ledger().charge(5_138_179_200)
    ckpt_io.save_checkpoint(str(tmp_path / "led"), 3, {"ledger": led.spent})
    from repro.checkpoint import io as jio
    with jax.enable_x64(True):
        got = jio.restore_checkpoint(str(tmp_path / "led"), 3,
                                     {"ledger": jnp.asarray(0, jnp.int64)})
        assert int(got["ledger"]) == led.spent
        jio.save_checkpoint(str(tmp_path / "jled"), 1,
                            {"ledger": jnp.asarray(led.spent, jnp.int64)})
    back = ckpt_io.restore_checkpoint(str(tmp_path / "jled"), 1, {"ledger": 0})
    assert ttr.Ledger(spent=back["ledger"]) == led


def test_sweep_over_transport_axes():
    """api.sweep over the transport's axes: each grid point is the fit of
    its spec, and with trials each trial keeps its own ledger."""
    base = tapi.ExperimentSpec(data=tapi.DataSpec(n_train=150, n_test=50),
                               solver=tapi.SolverSpec(n_sweeps=2, eps=0.0))
    grid = {"transport.topology": ["full", "star"],
            "transport.codec": ["exact_f64", "int8_affine"]}
    results = tapi.sweep(base, grid, device="cpu")
    specs = list(tapi.grid_specs(base, grid))
    assert [r.spec for r in results] == specs
    for res, spec in zip(results, specs):
        assert res.history.eta == tapi.fit(spec, device="cpu").history.eta
    byte_axis = {(r.spec.transport.topology, r.spec.transport.codec):
                 r.history.bytes_transmitted[1] for r in results}
    assert byte_axis[("star", "exact_f64")] == 1.8 * byte_axis[("full", "exact_f64")]
    budgeted = tapi.spec_with(base, "transport", tapi.TransportSpec(
        topology="star", byte_budget=0.75 * byte_axis[("star", "exact_f64")]))
    rsets = tapi.sweep(budgeted, {"transport.policy": ["greedy_eta", "truncate"]},
                       trials=3, device="cpu")
    for rs in rsets:
        for t, res in enumerate(rs):
            one = tapi.fit(tapi.trial_spec(rs.spec, t), device="cpu")
            assert res.history.bytes_transmitted == one.history.bytes_transmitted
