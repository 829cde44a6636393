"""repro_torch.stream against repro.stream: online ICOA on the port.

  * covstate.replace_col against the JAX package's (float64), a zero
    outgoing column an exact no-op downdate, the chunk commit replace_cols
    against as many successive JAX one-column swaps;
  * the stream's entry points run on the card unless asked for the CPU;
  * ChunkSource: the cosine and friedman1 chunks bit for bit in float32,
    with and without drift and noise, float64 within a few ulp (XLA's
    float64 sine and cosine are its own);
  * the JAX package's stream-equals-offline-fit case through the port;
  * stream_fit records (eta, train and prequential MSE, bytes, taps)
    against repro.api.stream_fit from the spec in float64 at 1e-10, with
    and without drift and under a crash FaultSpec;
  * checkpoints across packages: a stream saved by either resumes in the
    other to the other's uninterrupted records; a port resume is bit for
    bit the port's uninterrupted run; the legacy missing-leaf error;
  * PredictEngine: the direct ensemble, oversized batches, the JAX
    package's metric row names, a publisher and a request thread at once;
  * StreamSpec validation and its dict layout against the JAX package's.
"""
import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import covstate as jcov
from repro.stream import ChunkSource as JChunkSource
from repro.stream import PredictEngine as JEngine
from repro.stream.run import build_ingestor as jbuild_ingestor
from repro_torch import api as tapi
from repro_torch.core import covstate as tcov
from repro_torch.core import ensemble as tens
from repro_torch.stream import (CheckpointError, ChunkSource, PredictEngine,
                                build_ingestor, latest_stream_step,
                                restore_stream, save_stream)

ALL = ["accepts", "budget_rejects", "codec_error", "eta", "fault_retries", "s"]


class f64:
    """torch's default dtype float64 and jax's x64 inside the block."""

    def __enter__(self):
        self._dt = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)
        self._x64 = jax.enable_x64(True)
        self._x64.__enter__()
        japi.clear_dataset_cache()

    def __exit__(self, *exc):
        japi.clear_dataset_cache()
        self._x64.__exit__(*exc)
        torch.set_default_dtype(self._dt)


def _stream_dict(**kw):
    exp = {"data": {"source": "cosine", "seed": 2},
           "solver": {"n_sweeps": 3, "eps": 0.0,
                      "engine": kw.pop("engine", "fused")},
           "obs": {"taps": kw.pop("taps", ALL)}}
    if "faults" in kw:
        exp["faults"] = kw.pop("faults")
    d = {"experiment": exp, "window": 256, "chunk": 32, "resweep_every": 128,
         "total_instances": 512}
    d.update(kw)
    return d


def _same_records(trecs, jrecs, rtol=1e-10):
    assert len(trecs) == len(jrecs)
    for tr, jr in zip(trecs, jrecs):
        for k in ("count", "filled", "preq_n", "sweeps", "bytes",
                  "bytes_total"):
            assert tr[k] == jr[k], k
        for k in ("train_mse", "preq_mse", "eta"):
            np.testing.assert_allclose(tr[k], jr[k], rtol=rtol, err_msg=k)
        np.testing.assert_allclose(tr["etas"], jr["etas"], rtol=rtol)


# ------------------------------------------------------- rank-1 column swaps


def test_replace_col_matches_jax_f64():
    rng = np.random.default_rng(0)
    r = rng.standard_normal((5, 32))
    r0 = r.copy()
    r0[:, 7] = 0.0                               # an empty ring slot
    c_new = rng.standard_normal(5)
    with f64():
        for rr, j in ((r, 3), (r0, 7)):
            got = tcov.replace_col(tcov.build(torch.from_numpy(rr)), j,
                                   torch.from_numpy(c_new))
            want = jcov.replace_col(jcov.build(jnp.asarray(rr)), j,
                                    jnp.asarray(c_new))
            fresh = rr.copy()
            fresh[:, j] = c_new
            built = tcov.build(torch.from_numpy(fresh))
            for name in ("r_sub", "a0", "m_inv", "s", "eta_tilde"):
                np.testing.assert_allclose(
                    getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                    rtol=1e-12, atol=1e-13, err_msg=name)
                np.testing.assert_allclose(
                    getattr(got, name).numpy(), getattr(built, name).numpy(),
                    rtol=1e-10, atol=1e-12, err_msg=name)
        # a chunk of arrivals (the stream's commit) against as many
        # successive JAX one-column swaps, over empty and filled slots
        r0[:, 12:15] = 0.0
        c_chunk = rng.standard_normal((5, 6))
        got = tcov.replace_cols(tcov.build(torch.from_numpy(r0)), 10,
                                torch.from_numpy(c_chunk))
        want = jcov.build(jnp.asarray(r0))
        for t in range(6):
            want = jcov.replace_col(want, 10 + t, jnp.asarray(c_chunk[:, t]))
        for name in ("r_sub", "a0", "m_inv", "s", "eta_tilde"):
            np.testing.assert_allclose(
                getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                rtol=1e-10, atol=1e-12, err_msg=name)
    st = tcov.build(torch.from_numpy(r))
    m_inv, s = tcov._rank1_inverse_update(st.m_inv, st.s,
                                          torch.zeros(5, dtype=torch.float64), -1.0)
    assert torch.equal(m_inv, st.m_inv) and torch.equal(s, st.s)
    with pytest.raises(ValueError, match="past the window"):
        tcov.replace_cols(st, 30, torch.zeros((5, 4), dtype=torch.float64))


@pytest.mark.parametrize("entry", ["stream_fit", "build_ingestor",
                                   "Ingestor", "ChunkSource"])
def test_stream_entry_points_need_a_card_unless_asked(monkeypatch, entry):
    from repro_torch.stream import Ingestor

    spec = tapi.stream_spec_from_dict(_stream_dict())
    calls = {
        "stream_fit": lambda: tapi.stream_fit(spec),
        "build_ingestor": lambda: build_ingestor(spec),
        "Ingestor": lambda: Ingestor(
            build_ingestor(spec, device="cpu").family,
            spec.experiment.data.groups,
            spec.experiment.solver.icoa_config(None), 256, 32),
        "ChunkSource": lambda: ChunkSource("cosine", 32, 4),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


# ------------------------------------------------------------- the arrivals


@pytest.mark.parametrize("source,drift,noise", [
    ("cosine", False, 0.0), ("cosine", True, 0.0), ("cosine", True, 0.1),
    ("friedman1", False, 0.0), ("friedman1", False, 0.37),
])
def test_chunk_source_matches_jax(source, drift, noise):
    """The JAX package's compiled chunk program: float32 chunks bit for
    bit (its fused multiply-adds and folded constants, stream.source);
    float64 within 4 ulp (XLA's float64 sine and cosine are its own)."""
    kw = dict(drift_option="freq", drift_start=1.0, drift_end=1.4) if drift else {}
    for x64, dt in ((False, torch.float32), (True, torch.float64)):
        with jax.enable_x64(x64):
            jsrc = JChunkSource(source, 16, 100, seed=3, noise=noise, **kw)
            tsrc = ChunkSource(source, 16, 100, seed=3, noise=noise, dtype=dt,
                               device="cpu", **kw)
            for t in range(0, 100, 3):
                (jx, jy), (tx, ty) = jsrc(t), tsrc(t)
                assert tx.dtype == dt
                np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
                if x64:
                    np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                                               rtol=0, atol=4 * 2.0 ** -52)
                else:
                    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_stream_then_resweep_matches_offline_fit_f64():
    """The JAX package's own case: ingest N rows one at a time, resweep ==
    api.fit on the same N rows (repro.api's history at 1e-10)."""
    d = _stream_dict(window=384, chunk=1, total_instances=256,
                     resweep_every=256, sweeps_per_resweep=5, taps=[])
    d["experiment"]["data"].update(n_train=256, n_test=64)
    d["experiment"]["solver"]["n_sweeps"] = 5
    with f64():
        spec = tapi.stream_spec_from_dict(d)
        res = tapi.fit(spec.experiment, device="cpu")
        jres = japi.fit(japi.spec_from_dict(d["experiment"]))
        x = res.data.xcols[:, :, 0].T                  # one attribute an agent
        ing = build_ingestor(spec, device="cpu")
        state = ing.init_state()
        for i in range(x.shape[0]):
            state = ing.ingest(state, x[i:i + 1], res.data.y[i:i + 1])
        assert int(state.count) == 256 and int(state.live) == 0
        state, rec = ing.resweep(state)
    for hist in (res.history, jres.history):
        np.testing.assert_allclose(rec["etas"], hist.eta[1:], rtol=1e-10)
        np.testing.assert_allclose(rec["train_mse"], hist.train_mse[-1],
                                   rtol=1e-10)
        assert rec["bytes"] == int(sum(hist.bytes_transmitted))
    np.testing.assert_allclose(state.weights.numpy(), res.weights.numpy(),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(state.f[:, :256].numpy(), res.f.numpy(),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("case", ["plain", "drift", "crash"])
def test_stream_fit_matches_jax_f64(case):
    kw = {}
    if case == "drift":
        kw = dict(drift_option="freq", drift_start=1.0, drift_end=1.4,
                  engine="incremental")
    elif case == "crash":
        kw = dict(faults={"crash": [[1, 1, 3]]})
    d = _stream_dict(**kw)
    with f64():
        tres = tapi.stream_fit(tapi.stream_spec_from_dict(d), device="cpu")
        jres = japi.stream_fit(japi.stream_spec_from_dict(d))
    _same_records(tres.records, jres.records)
    assert tres.counts == [128, 256, 384, 512]
    for name in jres.metrics.names:
        got, want = tres.metrics[name], np.asarray(jres.metrics[name])
        assert got.dtype == want.dtype and got.shape == want.shape, name
        # normwise: the solve vector s of a drifting window's Gram carries
        # the float64 cosine's last-ulp differences a little further
        np.testing.assert_allclose(got, want, rtol=1e-10,
                                   atol=1e-10 * float(np.abs(want).max()),
                                   err_msg=name)
    np.testing.assert_allclose(tres.weights.numpy(), np.asarray(jres.weights),
                               rtol=1e-9, atol=1e-12)
    assert tres.metrics["eta"].tolist() == [e for r in tres.records
                                            for e in r["etas"]]
    if case == "crash":                  # agent 1 down in rounds 1 and 2
        assert tres.records[1]["count"] == 256
        assert tres.state.weights[1].item() != 0.0   # rejoined by round 3


# ------------------------------------------------------- elastic restarts


def test_checkpoints_resume_across_packages(tmp_path):
    """Each package resumes the other's checkpoint at 256 instances to the
    other's uninterrupted records (1e-10), and the port's own resume is its
    uninterrupted run bit for bit."""
    d = _stream_dict(checkpoint_every=256, taps=["eta", "accepts"],
                     faults={"seed": 5, "drop_rate": 0.3, "max_retries": 2})
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    with f64():
        tspec, jspec = tapi.stream_spec_from_dict(d), japi.stream_spec_from_dict(d)
        jfull = japi.stream_fit(jspec, checkpoint_dir=jdir)
        tfull = tapi.stream_fit(tspec, checkpoint_dir=tdir, device="cpu")
        assert latest_stream_step(jdir) == latest_stream_step(tdir) == 512
        for path in (jdir, tdir):          # resume from the mid-stream save
            for f in os.listdir(path):
                if f.startswith("ckpt_00000512"):
                    os.remove(os.path.join(path, f))
        # each resume saves at 512 again: the port resumes its own save first
        t_from_t = tapi.stream_fit(tspec, checkpoint_dir=tdir, resume=True,
                                   device="cpu")
        os.remove(os.path.join(tdir, "ckpt_00000512.npz"))
        t_from_j = tapi.stream_fit(tspec, checkpoint_dir=jdir, resume=True,
                                   device="cpu")
        j_from_t = japi.stream_fit(jspec, checkpoint_dir=tdir, resume=True)
    _same_records(tfull.records, jfull.records)
    assert len(t_from_j.records) == len(j_from_t.records) == len(t_from_t.records) == 2
    _same_records(t_from_j.records, jfull.records[2:])
    _same_records(j_from_t.records, tfull.records[2:])
    for a, b in zip(t_from_t.records, tfull.records[2:]):
        assert {k: v for k, v in a.items() if k != "taps"} == \
            {k: v for k, v in b.items() if k != "taps"}
        for k in a["taps"]:
            np.testing.assert_array_equal(a["taps"][k], b["taps"][k])
    assert torch.equal(t_from_t.state.f, tfull.state.f)
    assert torch.equal(t_from_t.weights, tfull.weights)


def test_legacy_checkpoint_missing_leaf_raises_named_error(tmp_path):
    spec = tapi.stream_spec_from_dict(_stream_dict(window=128, chunk=64,
                                                   total_instances=128,
                                                   resweep_every=128))
    ing = build_ingestor(spec, device="cpu")
    state = ing.init_state()._replace(count=np.int32(64))
    ckdir = str(tmp_path / "ck")
    save_stream(ckdir, state)
    npz = os.path.join(ckdir, "ckpt_00000064.npz")
    man = os.path.join(ckdir, "ckpt_00000064.json")
    arrays = dict(np.load(npz))
    assert ".rounds" in arrays and ".ledger|.spent" in arrays
    del arrays[".rounds"]
    np.savez_compressed(npz, **arrays)
    manifest = json.load(open(man))
    manifest["keys"] = [k for k in manifest["keys"] if k != ".rounds"]
    json.dump(manifest, open(man, "w"))
    with pytest.raises(CheckpointError, match=r"\.rounds.*README"):
        restore_stream(ckdir, like=ing.init_state())
    ck2 = str(tmp_path / "ck2")
    save_stream(ck2, state)
    restored, step = restore_stream(ck2, like=ing.init_state())
    assert step == 64 and int(restored.count) == 64
    assert isinstance(restored.count, np.int32)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        tapi.stream_fit(spec, resume=True, device="cpu")


# ------------------------------------------------------------- serving


def test_predict_engine_serves_the_live_ensemble():
    spec = tapi.stream_spec_from_dict(_stream_dict(taps=[], serve_buckets=[4, 16]))
    groups = spec.experiment.data.groups
    engine = PredictEngine(build_ingestor(spec, device="cpu").family, groups, 5,
                           buckets=spec.serve_buckets)
    answers, errors, stop = [], [], threading.Event()
    xq = torch.rand((37, 5), generator=torch.Generator().manual_seed(3))

    def requests():
        while not stop.is_set():
            try:
                if engine._live is not None:
                    answers.append(engine.predict(xq[:7]))
            except Exception as e:                   # noqa: BLE001
                errors.append(e)
                return

    worker = threading.Thread(target=requests)
    worker.start()
    try:
        res = tapi.stream_fit(spec, engine=engine, device="cpu")
    finally:
        stop.set()
        worker.join()
    assert not errors and answers
    assert all(bool(torch.isfinite(a).all()) and a.shape == (7,) for a in answers)

    def direct(x):
        xc = torch.stack([x[:, g] for g in groups])
        return tens.combine(res.weights, res.family.predict(res.params, xc))

    for n in (4, 16):                          # at a bucket's size: the same bits
        assert torch.equal(engine.predict(xq[:n]), direct(xq[:n]))
    for n in (1, 7, 37):                       # padded and strided
        np.testing.assert_allclose(engine.predict(xq[:n]).numpy(),
                                   direct(xq[:n]).numpy(), rtol=1e-12, atol=1e-15)
    assert engine.latency[16].count >= 3       # 37 rows stride 16 + 16 + 5
    rows = engine.metrics_rows(res.ingestor)
    text = engine.metrics_text(res.ingestor)
    assert "repro_stream_resweeps_total 4.0" in text

    jspec = japi.stream_spec_from_dict(_stream_dict(taps=[], serve_buckets=[4, 16]))
    jing = jbuild_ingestor(jspec)
    jeng = JEngine(jing.family, jspec.experiment.data.groups, 5, buckets=(4, 16))
    jrows = jeng.metrics_rows(jing)
    assert [(r[0], r[1], r[2], r[4]) for r in rows] == \
        [(r[0], r[1], r[2], r[4]) for r in jrows]


def test_predict_engine_publishes_whole_snapshots_under_contention():
    """Eight request threads against a publisher cycling through 50
    versions of (params, weights), with a short switch interval, until 200
    answers and two rounds of publishes: every answer is one published version's ensemble exactly,
    never a mix of two."""
    import sys
    import time

    from repro_torch.agents import PolynomialFamily

    fam = PolynomialFamily(n_cols=1, degree=2)
    groups = [[0], [1], [2]]
    gen = torch.Generator().manual_seed(5)
    versions = [(torch.randn((3, fam.n_features), generator=gen),
                 torch.softmax(torch.randn(3, generator=gen), 0)) for _ in range(50)]
    x = torch.rand((5, 3), generator=gen)
    xc = torch.stack([x[:, g] for g in groups])
    want = [tens.combine(w, fam.predict(p, xc)) for p, w in versions]
    engine = PredictEngine(fam, groups, 3, buckets=(8,))
    engine.update(*versions[0])
    answers, stop = [], threading.Event()

    def requests():
        while not stop.is_set():
            answers.append(engine.predict(x))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    workers = [threading.Thread(target=requests) for _ in range(8)]
    deadline = time.monotonic() + 60.0
    try:
        for w in workers:
            w.start()
        k = 0
        while ((len(answers) < 200 or k < 2 * len(versions))
               and time.monotonic() < deadline):
            engine.update(*versions[k % len(versions)])
            k += 1
    finally:
        stop.set()
        for w in workers:
            w.join(timeout=60)
        sys.setswitchinterval(old)
    assert not any(w.is_alive() for w in workers)
    assert len(answers) >= 200 and k >= 2 * len(versions)
    for a in answers:
        assert any(torch.equal(a, v) for v in want)


# ------------------------------------------------------------------ specs


def test_stream_spec_validation_and_dicts_match_jax():
    d = _stream_dict(drift_option="freq", drift_start=1.0, drift_end=1.2,
                     checkpoint_every=256, serve_buckets=[1, 8])
    tspec, jspec = tapi.stream_spec_from_dict(d), japi.stream_spec_from_dict(d)
    assert tapi.stream_spec_to_dict(tspec) == japi.stream_spec_to_dict(jspec)
    again = tapi.stream_spec_from_dict(
        json.loads(json.dumps(japi.stream_spec_to_dict(jspec))))
    assert again == tspec
    bad = [
        ({"experiment": {"solver": {"name": "averaging"}}}, "no sweep to cadence"),
        ({"experiment": {"solver": {"alpha": 10.0}}}, "alpha=1"),
        ({"experiment": {"backend": {"name": "shard_map"}}}, "local backend only"),
        ({"window": 100}, "multiple of chunk"),
        ({"checkpoint_every": 40}, "multiple of chunk"),
        ({"serve_buckets": []}, "serve_buckets"),
        ({"drift_option": "rho"}, "no option 'rho'"),
        ({"chunk": 0}, "chunk >= 1"),
    ]
    for change, msg in bad:
        dd = {"window": 256, "chunk": 32, "resweep_every": 128,
              "total_instances": 512, "experiment": {"data": {"source": "cosine"}}}
        for k, v in change.items():
            if k == "experiment":
                dd["experiment"].update(v)
            else:
                dd[k] = v
        with pytest.raises(tapi.SpecError, match=msg):
            tapi.stream_spec_from_dict(dd).validate()
        with pytest.raises(japi.SpecError):
            japi.stream_spec_from_dict(dd).validate()
    with pytest.raises(tapi.SpecError, match="unrecognised"):
        tapi.stream_spec_from_dict({"windw": 3})
