"""repro_torch.obs against repro.obs: the in-sweep taps, the span tracer and
the runtime-health primitives.

  * every tap of repro_torch.api.fit and batch_fit against repro.api's on
    each engine (dense, incremental, fused), under a byte budget (the
    greedy_eta batch: one agent per trial), the JAX package's full
    FaultSpec, a lossy codec and Minimax Protection (alpha 20, delta
    0.01), from the spec in float64: float taps at
    1e-10, the int taps equal, `Metrics.as_dict()` keys, axes and dtype
    strings equal, and the histories at 1e-10;
  * off vs on: the same histories and weights bit for bit, `metrics is
    None` off, and the eta tap bitwise History.eta[1:];
  * the taps' own contracts: codec_error 0 on an exact codec and > 0 on
    int8_affine, fault_retries times the broadcast price equal to the
    ledger's retry bytes, budget_rejects bounding the accepts;
  * prometheus_text equal to the JAX package's on the same rows, and the
    tracer's JSONL rendered by tools/obs_report.py.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.obs import health as jhealth
from repro_torch import api as tapi
from repro_torch import obs as tobs
from repro_torch.obs import health as thealth

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ALL = ["accepts", "budget_rejects", "codec_error", "eta", "fault_retries", "s"]
FULL_FAULTS = {"seed": 5, "drop_rate": 0.3, "corrupt_rate": 0.2,
               "corrupt_bits": 4, "straggle_rate": 0.1, "max_retries": 2,
               "crash": [[1, 1, 3]]}
# the clean paper-like cell below costs 9600 bytes a sweep: the budget
# runs out in the third sweep
CASES = {
    "plain": {},
    "budget": {"transport": {"byte_budget": 24000.0, "policy": "greedy_eta"}},
    "faults": {"faults": FULL_FAULTS},
    "int8": {"transport": {"codec": "int8_affine"}},
    "mm": {},                      # Minimax Protection: alpha 20, delta 0.01
}


def _dict(engine, case, taps=ALL, n_sweeps=4):
    d = {"data": {"n_train": 120, "n_test": 80, "seed": 7},
         "agent": {"family": "polynomial", "options": [["degree", 3]]},
         "solver": {"n_sweeps": n_sweeps, "eps": 0.0, "engine": engine},
         "seed": 1, "obs": {"taps": list(taps)}}
    d.update(CASES[case])
    if case == "mm":
        d["solver"].update(alpha=20.0, delta=0.01, minimax_steps=40)
    return d


def _port(fn, d, *args):
    dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        return fn(tapi.spec_from_dict(d), *args, device="cpu")
    finally:
        torch.set_default_dtype(dt)


def _jax(fn, d, *args):
    japi.clear_dataset_cache()
    try:
        with jax.enable_x64(True):
            return fn(japi.spec_from_dict(d), *args)
    finally:
        japi.clear_dataset_cache()


def _same_metrics(tm, jm):
    assert tm is not None and jm is not None
    tdict, jdict = tm.as_dict(), jm.as_dict()
    assert sorted(tdict) == sorted(jdict) == sorted(tm.names)
    for name in jdict:
        assert tdict[name]["axes"] == jdict[name]["axes"], name
        assert tdict[name]["dtype"] == jdict[name]["dtype"], name
        assert tdict[name]["desc"] == jdict[name]["desc"], name
        got, want = tm[name], np.asarray(jm[name])
        assert got.shape == want.shape, name
        if want.dtype.kind == "i":
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-13,
                                       err_msg=name)


def _same_history(th, jh):
    for key in ("train_mse", "test_mse", "eta"):
        np.testing.assert_allclose(getattr(th, key), getattr(jh, key),
                                   rtol=1e-10, err_msg=key)
    assert th.bytes_transmitted == jh.bytes_transmitted


@pytest.mark.parametrize("engine,case", [
    ("dense", "plain"), ("dense", "int8"),
    ("incremental", "plain"), ("incremental", "budget"),
    ("incremental", "faults"), ("incremental", "int8"),
    ("fused", "plain"), ("fused", "budget"), ("fused", "faults"),
    ("fused", "int8"), ("dense", "mm"), ("fused", "mm"),
])
def test_fit_taps_match_jax_f64(engine, case):
    d = _dict(engine, case)
    tres, jres = _port(tapi.fit, d), _jax(japi.fit, d)
    _same_history(tres.history, jres.history)
    _same_metrics(tres.metrics, jres.metrics)
    assert tres.metrics.n_sweeps == len(tres.history.eta) - 1
    # the eta tap is the recorded eta itself
    assert tres.metrics["eta"].tolist() == tres.history.eta[1:]


@pytest.mark.parametrize("engine,case", [
    ("dense", "int8"), ("incremental", "faults"), ("fused", "budget"),
    ("incremental", "mm"),
])
def test_batch_fit_taps_match_jax_f64(engine, case):
    """batch_fit's Metrics per trial (trial axis sliced off), against the
    JAX package's vmapped run: the budgeted greedy_eta batch updates one
    agent per trial at each slot."""
    d = _dict(engine, case, n_sweeps=3)
    trs, jrs = _port(tapi.batch_fit, d, 3), _jax(japi.batch_fit, d, 3)
    for t in range(3):
        _same_history(trs[t].history, jrs[t].history)
        _same_metrics(trs[t].metrics, jrs[t].metrics)
        assert trs[t].metrics["eta"].tolist() == trs[t].history.eta[1:]
    if case == "budget":
        rejects = [int(r.metrics["budget_rejects"].sum()) for r in trs]
        assert min(rejects) > 0


@pytest.mark.parametrize("engine,case", [
    ("dense", "plain"), ("incremental", "budget"), ("fused", "faults"),
    ("fused", "int8"),
])
def test_taps_off_and_on_give_the_same_run(engine, case):
    off = _port(tapi.fit, _dict(engine, case, taps=()))
    on = _port(tapi.fit, _dict(engine, case))
    assert off.metrics is None and on.metrics is not None
    assert off.history.as_dict() == on.history.as_dict()
    assert torch.equal(off.weights, on.weights) and torch.equal(off.f, on.f)
    assert on.metrics["eta"].tolist() == on.history.eta[1:]
    boff = _port(tapi.batch_fit, _dict(engine, case, taps=(), n_sweeps=2), 2)
    bon = _port(tapi.batch_fit, _dict(engine, case, n_sweeps=2), 2)
    for a, b in zip(boff, bon):
        assert a.metrics is None
        assert a.history.as_dict() == b.history.as_dict()
        assert torch.equal(a.weights, b.weights)
        assert b.metrics["eta"].tolist() == b.history.eta[1:]
        assert b.metrics["accepts"].shape == (2, 5)


def test_tap_contracts():
    """codec_error 0 on the exact codec and in (0, 1) on int8_affine; on
    the full topology with drops only, the faulted run's extra bytes are
    fault_retries times the one broadcast price; a budget's denials bound
    the accepts."""
    exact = _port(tapi.fit, _dict("fused", "plain"))
    assert np.all(exact.metrics["codec_error"] == 0.0)
    assert np.all(exact.metrics["budget_rejects"] == 0)
    assert np.all(exact.metrics["fault_retries"] == 0)
    lossy = _port(tapi.fit, _dict("fused", "int8"))
    err = lossy.metrics["codec_error"]
    assert np.all(err > 0.0) and np.all(err < 1.0)

    drops = _dict("incremental", "plain")
    drops["faults"] = {"seed": 5, "drop_rate": 0.4, "max_retries": 3}
    faulted = _port(tapi.fit, drops)
    retries = int(faulted.metrics["fault_retries"].sum())
    assert retries > 0
    bcosts = tapi.spec_from_dict(drops).resolved_transport().broadcast_costs(120, False)
    assert len(set(bcosts)) == 1
    overhead = (sum(faulted.history.bytes_transmitted)
                - sum(exact.history.bytes_transmitted))
    assert overhead == retries * bcosts[0]

    budget = _port(tapi.fit, _dict("fused", "budget"))
    rejects = int(budget.metrics["budget_rejects"].sum())
    assert 0 < rejects <= 4 * 5
    assert int(budget.metrics["accepts"].sum()) <= 4 * 5 - rejects


def test_obs_spec_errors_match_jax():
    with pytest.raises(tapi.SpecError, match="obs: unknown tap"):
        tapi.ExperimentSpec(obs=tapi.ObsSpec(taps=("nope",))).validate()
    with pytest.raises(tobs.ObsError):
        tobs.ObsSpec(taps=("nope",)).validate()
    with pytest.raises(tapi.SpecError, match="no sweep to tap"):
        tapi.ExperimentSpec(solver=tapi.SolverSpec(name="averaging"),
                            obs=tapi.ObsSpec(taps=("eta",))).validate()
    assert tobs.ObsSpec().normalized() is None
    assert tobs.ObsSpec(taps=("s", "eta", "s")).normalized() == \
        tobs.ObsSpec(taps=("eta", "s"))
    from repro.obs import spec as jspec
    assert tobs.TAPS == jspec.TAPS and tobs.ALL_TAPS == jspec.ALL_TAPS


def test_prometheus_text_and_health_match_jax():
    rows = [("a_total", "counter", "things", 3.0, None),
            ("lat", "gauge", "latency", 0.25, {"bucket": "16", "quantile": "p50"}),
            ("lat", "gauge", "ignored", float("nan"), {"bucket": "1"}),
            ("rate", "gauge", "r", 1.5e-7, {"z": "1", "a": "2"})]
    assert thealth.prometheus_text(rows) == jhealth.prometheus_text(rows)
    tring, jring = thealth.LatencyRing(capacity=8), jhealth.LatencyRing(capacity=8)
    for v in np.linspace(0.001, 0.02, 13):
        tring.observe(v)
        jring.observe(v)
    assert tring.percentiles() == jring.percentiles()
    assert tring.count == jring.count == 13
    assert np.isnan(thealth.LatencyRing().percentiles()["p99"])
    c = thealth.Counter()
    c.add()
    c.add(4)
    assert c.total == 5 and c.rate >= 0.0


def test_tracer_jsonl_renders_through_obs_report(tmp_path):
    """The tracer's schema (spans close after what they hold, events in
    between), the api.fit span, and tools/obs_report.py over a stream_fit
    log: its tables and its ledger cross-check pass."""
    path = str(tmp_path / "events.jsonl")
    assert not tobs.active()
    tobs.configure(path, run_id="t1")
    try:
        with tobs.trace("outer", case="schema"):
            with tobs.step("inner", 3):
                pass
            tobs.event("mark", round=3, agent=1)
        _port(tapi.fit, _dict("fused", "plain", taps=(), n_sweeps=1))
        spec = tapi.StreamSpec(
            experiment=tapi.ExperimentSpec(data=tapi.DataSpec(source="cosine"),
                                           solver=tapi.SolverSpec(n_sweeps=2)),
            window=128, chunk=32, total_instances=256, resweep_every=64)
        tapi.stream_fit(spec, device="cpu")
    finally:
        tobs.disable()
    assert not tobs.active()
    rows = [json.loads(line) for line in open(path)]
    assert [r["name"] for r in rows[:3]] == ["inner", "mark", "outer"]
    assert rows[0]["tags"] == {"step": 3} and rows[2]["tags"] == {"case": "schema"}
    assert all(r["run"] == "t1" and set(r) >= {"ev", "name", "t", "tags"}
               for r in rows)
    assert any(r["name"] == "api.fit" and r["tags"]["solver"] == "icoa"
               for r in rows)
    records = [r for r in rows if r["name"] == "stream.record"]
    assert len(records) == 4
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "obs_report.py"), path],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "stream.resweep" in out.stdout and "[OK]" in out.stdout
    with tobs.trace("ignored"):
        tobs.event("also-ignored")
    assert len(open(path).readlines()) == len(rows)
