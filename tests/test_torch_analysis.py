"""repro_torch.analysis against repro.analysis: the sanitizer rail, the lint
and the compile and capture auditor of the port.

  * sanitize: the check helpers are the identity with the sites off,
    scopes nest innermost-wins, unknown modes are refused; a NaN codec
    raises the located error in fit and in a batch (naming the first
    failing trial) with the site string of repro's own checked run on the
    same inputs; a singular SMW pivot names covstate._smw_pieces, a
    singular Sherman–Morrison pivot _rank1_inverse_update, and the
    kernels' CPU paths check nothing (as the kernels do); a checked run
    reads its error word at most once a sweep;
  * raise gives the off mode's bits in fit, batch_fit and stream_fit on
    every engine, with use_kernel both ways; the port in raise mode equals
    repro.api in off mode at 1e-10 in float64 with byte ledgers equal (the
    batch against the reference's off mode: its checked batch fails, C2);
  * lint: every rule fires on its bad source and stays silent on its good
    one; the port's tree lints clean; mutable-static-field and
    registry-signature give the reference lint's verdicts on its fixtures;
  * recompile: the log, nesting, the budget, the audit round trip, the
    environment install and the check command, in a subprocess.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

from repro import api as japi
from repro import transport as jtransport
from repro.agents import LinearFamily as JLinear
from repro.analysis import lint as jlint
from repro.core import icoa as jicoa
from repro.transport import codecs as jcodecs
from repro_torch import api as tapi
from repro_torch import transport as ttransport
from repro_torch.agents import LinearFamily as TLinear
from repro_torch.analysis import lint, recompile, sanitize
from repro_torch.analysis.sanitize import CheckError
from repro_torch.core import covstate, icoa
from repro_torch.kernels.sweep import ops as sweep_ops
from repro_torch.kernels.sweep import ref as sweep_ref
from repro_torch.transport import codecs as tcodecs

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURES = os.path.join(REPO, "tests", "lint_fixtures")
RELAY_SITE = ("non-finite value in transport relay: codec 'nan_injector' "
              "delivered a non-finite payload over topology 'full'")


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


# ------------------------------------------------------- the NaN codec twins


@dataclasses.dataclass(frozen=True)
class _JNaN(jcodecs.Codec):
    """The reference test's codec: every delivered payload poisoned."""

    def decode(self, payload):
        return payload * jnp.nan

    def nbytes(self, n_elems: int) -> float:
        return float(8 * n_elems)

    def is_identity_for(self, dtype) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class _TNaN(tcodecs.Codec):
    def decode(self, payload):
        return payload * float("nan")

    def nbytes(self, n_elems: int) -> float:
        return float(8 * n_elems)

    def is_identity_for(self, dtype) -> bool:
        return False


@pytest.fixture(scope="module")
def nan_codec():
    """"nan_injector" in both packages' codec registries for the module."""
    jtransport.register_codec("nan_injector")(lambda: _JNaN(name="nan_injector"))
    ttransport.register_codec("nan_injector")(lambda: _TNaN(name="nan_injector"))
    yield
    jcodecs.CODECS.pop("nan_injector", None)
    tcodecs.CODECS.pop("nan_injector", None)


def _data(d=3, n=48, seed=0):
    """The reference test's data, as numpy."""
    kx, ky = jax.random.split(jax.random.PRNGKey(seed))
    x = jax.random.normal(kx, (n, d))
    y = x @ jnp.arange(1.0, d + 1.0) + 0.1 * jax.random.normal(ky, (n,))
    xcols = jnp.stack([x[:, [i]] for i in range(d)])
    return np.asarray(xcols), np.asarray(y)


def _site(err) -> str:
    """checkify's message without its "(`check` failed)" tail."""
    return str(err).split(" (`check` failed)")[0]


# --------------------------------------------------------- the helpers, off


def test_check_helpers_are_identity_when_off():
    x = torch.ones((3,), dtype=torch.float32, device="cpu")
    idx = torch.arange(3, dtype=torch.int64, device="cpu")
    assert not sanitize.checks_enabled()
    assert sanitize.check_finite(x, "t") is x
    assert sanitize.check_nonzero(x, "t") is x
    assert sanitize.check_in_bounds(idx, 3, "t") is idx
    with sanitize.error_scope("off") as word:
        assert word is None and not sanitize.checks_enabled()
        assert sanitize.check_finite(x * np.nan, "t") is not None


def test_sanitize_scope_nests_innermost_wins():
    assert not sanitize.checks_enabled()
    with sanitize.sanitize_scope("raise"):
        assert sanitize.checks_enabled()
        with sanitize.sanitize_scope("off"):
            assert not sanitize.checks_enabled()
        assert sanitize.checks_enabled()
    assert not sanitize.checks_enabled()
    with sanitize.error_scope("raise") as outer:
        with sanitize.error_scope("off"):
            # an off sweep inside a checked run folds nothing
            sanitize.check_nonzero(torch.zeros((), dtype=torch.float64,
                                               device="cpu"), "inner off")
        with sanitize.error_scope("raise") as inner:
            assert inner is outer              # joins the outer word
    assert outer.word is None


def test_validate_mode_rejects_unknown():
    with pytest.raises(ValueError, match="ICOAConfig.checks"):
        sanitize.validate_mode("verbose", "ICOAConfig.checks")
    with pytest.raises(tapi.SpecError, match="BackendSpec.checks"):
        tapi.BackendSpec(checks="bogus").validate()
    xcols, y = _data()
    with pytest.raises(ValueError, match="checks"):
        icoa.run(TLinear(n_cols=1), icoa.ICOAConfig(checks="debug"),
                 torch.from_numpy(xcols), torch.from_numpy(y))


def test_error_word_keeps_the_first_failure_of_each_trial():
    word = sanitize.ErrorWord(trials=4)
    word.fold(torch.tensor([False, False, True, False], dtype=torch.bool,
                           device="cpu"), "site a")
    word.fold(torch.tensor([[False], [True], [True], [False]],
                           dtype=torch.bool, device="cpu"), "site b")
    assert word.word.tolist() == [0, 2, 1, 0]
    err = word.error()
    assert isinstance(err, RuntimeError) and err.trial == 1
    assert str(err) == "site b (trial 1 of 4)" and err.site == "site b"
    single = sanitize.ErrorWord()
    single.fold(torch.zeros((5,), dtype=torch.bool, device="cpu"), "never")
    assert single.error() is None
    single.fold(torch.ones((2, 2), dtype=torch.bool, device="cpu"), "all")
    with pytest.raises(CheckError, match="^all$"):
        single.throw()


def test_a_site_outside_a_checked_run_says_so():
    with sanitize.sanitize_scope("raise"):
        with pytest.raises(RuntimeError, match="outside a checked run"):
            sanitize.check_finite(torch.zeros((1,), dtype=torch.float32,
                                              device="cpu"), "lone")


# ------------------------------------------------ located errors, NaN codec


def test_nan_codec_raises_the_reference_site_in_run():
    """icoa.run under checks="raise" on the reference test's inputs: the
    port's CheckError carries the site string repro's checkify error
    carries, word for word."""
    d = 3
    xcols, y = _data(d)
    jtp = jtransport.Transport(topology=jtransport.build_topology("full", d),
                               codec=_JNaN(name="nan_injector"))
    with pytest.raises(checkify.JaxRuntimeError) as jerr:
        jicoa.run(JLinear(n_cols=1),
                  jicoa.ICOAConfig(n_sweeps=1, transport=jtp, checks="raise"),
                  jnp.asarray(xcols), jnp.asarray(y), seed=0)
    ttp = ttransport.Transport(topology=ttransport.build_topology("full", d),
                               codec=_TNaN(name="nan_injector"))
    for engine in ("incremental", "fused", "dense"):
        cfg = icoa.ICOAConfig(n_sweeps=1, transport=ttp, checks="raise",
                              engine=engine)
        with pytest.raises(CheckError) as terr:
            icoa.run(TLinear(n_cols=1), cfg, torch.from_numpy(xcols),
                     torch.from_numpy(y), seed=0)
        assert str(terr.value) == _site(jerr.value) == RELAY_SITE, engine
        assert terr.value.trial is None
        # off: the silent corruption the rail exists for (no error)
        icoa.run(TLinear(n_cols=1), dataclasses.replace(cfg, checks="off"),
                 torch.from_numpy(xcols), torch.from_numpy(y), seed=0)


@pytest.mark.parametrize("engine", ["incremental", "fused", "dense"])
def test_nan_codec_raises_in_fit_and_batch(nan_codec, engine):
    """From the spec: repro's checked fit and the port's give the same
    site; the port's batch names the site and its first failing trial."""
    d = {"data": {"n_train": 120, "n_test": 60}, "transport":
         {"codec": "nan_injector"}, "backend": {"checks": "raise"},
         "solver": {"n_sweeps": 2, "engine": engine}}
    with pytest.raises(checkify.JaxRuntimeError) as jerr:
        japi.fit(japi.spec_from_dict(d))
    spec = tapi.spec_from_dict(d)
    with pytest.raises(CheckError) as terr:
        tapi.fit(spec, device="cpu")
    assert str(terr.value) == _site(jerr.value) == RELAY_SITE
    with pytest.raises(CheckError) as berr:
        tapi.batch_fit(spec, 4, device="cpu")
    assert berr.value.site == RELAY_SITE and berr.value.trial == 0
    assert str(berr.value) == RELAY_SITE + " (trial 0 of 4)"


def test_nan_codec_raises_in_residual_refitting_batch(nan_codec):
    spec = tapi.ExperimentSpec(
        data=tapi.DataSpec(n_train=80, n_test=40),
        solver=tapi.SolverSpec(name="residual_refitting", n_sweeps=2),
        transport=tapi.TransportSpec(codec="nan_injector"),
        backend=tapi.BackendSpec(checks="raise"))
    with pytest.raises(CheckError, match="baselines leave-one-out refit: "
                       "codec 'nan_injector'") as err:
        tapi.batch_fit(spec, 3, device="cpu")
    assert err.value.trial == 0


def test_singular_smw_pivot_raises_named_division_error():
    """det = k11 k22 - k12^2 is exactly 0 for u = -e0/2 against m_inv = I,
    as in the reference test: the check names covstate._smw_pieces; a
    well-conditioned probe passes and equals the bare one."""
    d, m = 3, 8
    eye = torch.eye(d, dtype=torch.float32, device="cpu")
    s = eye @ torch.ones((d,), dtype=torch.float32, device="cpu")
    state = covstate.CovState(r_sub=torch.zeros((d, m), dtype=torch.float32,
                                                device="cpu"),
                              a0=eye, m_inv=eye, s=s, eta_tilde=torch.sum(s))
    probe = sanitize.checked(covstate.eta_probe)
    with pytest.raises(CheckError, match="^division by zero in "
                       r"covstate._smw_pieces: SMW pivot determinant \(eta_probe"):
        probe(state, 0, -0.5 * eye[0])
    u_ok = 0.1 * torch.ones((d,), dtype=torch.float32, device="cpu")
    assert torch.equal(probe(state, 0, u_ok), covstate.eta_probe(state, 0, u_ok))
    # the batched twin: only trial 1's probe is singular
    bstate = covstate.CovState(*(t.expand(3, *t.shape).clone() for t in state))
    u = torch.stack([u_ok, -0.5 * eye[0], u_ok])
    with pytest.raises(CheckError) as err:
        sanitize.checked(covstate.eta_probe, trials=3)(bstate, 0, u)
    assert err.value.trial == 1 and "covstate._smw_pieces" in err.value.site


def test_singular_sherman_morrison_downdate_is_named():
    """Downdating by v with v.M v = 1 divides by zero in replace_col."""
    eye = torch.eye(3, dtype=torch.float64, device="cpu")
    s = torch.ones((3,), dtype=torch.float64, device="cpu")
    v = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64, device="cpu")
    with pytest.raises(CheckError, match="_rank1_inverse_update: "
                       "Sherman-Morrison pivot"):
        sanitize.checked(covstate._rank1_inverse_update)(eye, s, v, -1.0)


def test_sweep_ref_sites_and_kernel_paths_check_nothing():
    """The fused engine's plain closed forms hold the reference's sites;
    the kernels' CPU paths run them with the sites off (the kernels check
    nothing)."""
    d, n = 3, 16
    eye = torch.eye(d, dtype=torch.float32, device="cpu")
    s = torch.ones((d,), dtype=torch.float32, device="cpu")
    r = torch.zeros((d, n), dtype=torch.float32, device="cpu")
    delta = torch.zeros((n,), dtype=torch.float32, device="cpu")
    args = (r, eye, s, torch.sum(s), 0, delta, 0.0, -0.5, float("-inf"), True)
    with pytest.raises(CheckError, match="commit_sweep_ref: SMW pivot"):
        sanitize.checked(sweep_ref.commit_sweep_ref)(*args)
    with pytest.raises(CheckError, match="commit_sweep_ref: SMW pivot"):
        sanitize.checked(sweep_ref.commit_sweep_batched_ref, trials=1)(
            r[None], eye[None], s[None], torch.sum(s)[None], 0, delta[None],
            0.0, -0.5, float("-inf"), True)
    sanitize.checked(sweep_ops.commit_sweep)(*args)        # no error
    steps = torch.ones((2,), dtype=torch.float32, device="cpu")
    p = torch.zeros((d,), dtype=torch.float32, device="cpu")
    with pytest.raises(CheckError, match="probe_etas_closed: SMW pivot"):
        # p = 0 and m_inv = I: det = -1 - 2 beta, 0 at beta = c2h = -1/2
        sanitize.checked(sweep_ref.probe_etas_closed)(
            eye, s, torch.sum(s), 0, steps, p, 0.0, -0.5)


def test_checked_run_reads_its_word_at_most_once_a_sweep(monkeypatch):
    reads = []
    real = sanitize.ErrorWord.error
    monkeypatch.setattr(sanitize.ErrorWord, "error",
                        lambda self: reads.append(1) or real(self))
    spec = tapi.ExperimentSpec(data=tapi.DataSpec(n_train=100, n_test=50),
                               solver=tapi.SolverSpec(n_sweeps=4, eps=0.0),
                               backend=tapi.BackendSpec(checks="raise"))
    res = tapi.fit(spec, device="cpu")
    assert len(res.history.eta) == 5 and len(reads) <= 4 + 1
    reads.clear()
    tapi.batch_fit(spec, 3, device="cpu")
    assert len(reads) == 1                     # once, at the end


# --------------------------------------------------- raise = off, bit for bit

ENGINES = [("incremental", False), ("incremental", True), ("fused", False),
           ("fused", True), ("dense", False)]


def _same_bits(a, b, fields=("train_mse", "test_mse", "eta",
                             "bytes_transmitted")):
    for k in fields:
        assert getattr(a.history, k) == getattr(b.history, k), k


@pytest.mark.parametrize("engine,use_kernel", ENGINES)
def test_raise_equals_off_in_fit_and_batch(engine, use_kernel):
    base = tapi.ExperimentSpec(
        data=tapi.DataSpec(n_train=150, n_test=60),
        solver=tapi.SolverSpec(n_sweeps=3, engine=engine, use_kernel=use_kernel,
                               alpha=1.0 if engine != "incremental" else 4.0),
        transport=tapi.TransportSpec(codec="int8_affine"))
    on = dataclasses.replace(base, backend=tapi.BackendSpec(checks="raise"))
    a, b = tapi.fit(base, device="cpu"), tapi.fit(on, device="cpu")
    _same_bits(a, b)
    assert torch.equal(a.weights, b.weights) and torch.equal(a.f, b.f)
    ra, rb = tapi.batch_fit(base, 3, device="cpu"), tapi.batch_fit(on, 3,
                                                                   device="cpu")
    for k in ("train_mse", "test_mse", "eta", "bytes_transmitted"):
        assert np.array_equal(ra.stack(k), rb.stack(k)), k


@pytest.mark.parametrize("engine", ["incremental", "fused"])
@pytest.mark.parametrize("change", [
    pytest.param({"transport": {"topology": "star", "byte_budget": 3000.0,
                                "policy": "greedy_eta"}}, id="budget-greedy"),
    pytest.param({"transport": {"codec": "topk_sparse", "byte_budget": 3000.0,
                                "policy": "truncate"}}, id="budget-truncate"),
    pytest.param({"faults": {"seed": 5, "drop_rate": 0.3, "max_retries": 2,
                             "corrupt_rate": 0.2, "corrupt_bits": 4,
                             "straggle_rate": 0.1, "crash": [[1, 1, 2]]}},
                 id="faults"),
    pytest.param({"solver": {"alpha": 20.0, "delta": 0.01}}, id="minimax"),
    pytest.param({"obs": {"taps": ["eta", "s", "accepts", "codec_error"]}},
                 id="taps"),
])
def test_raise_equals_off_under_budgets_faults_minimax_taps(engine, change):
    """raise gives off's bits under a byte budget (both policies), the full
    FaultSpec, Minimax Protection and taps, in fit and a 3-trial batch."""
    d = {"data": {"n_train": 150, "n_test": 60}, "seed": 1, **change}
    d["solver"] = {"n_sweeps": 3, "engine": engine, **d.get("solver", {})}
    off = tapi.spec_from_dict(d)
    on = dataclasses.replace(off, backend=tapi.BackendSpec(checks="raise"))
    _same_bits(tapi.fit(off, device="cpu"), tapi.fit(on, device="cpu"))
    ra, rb = tapi.batch_fit(off, 3, device="cpu"), tapi.batch_fit(on, 3,
                                                                  device="cpu")
    for k in ("train_mse", "test_mse", "eta", "bytes_transmitted"):
        assert np.array_equal(ra.stack(k), rb.stack(k)), k


@pytest.mark.parametrize("engine,use_kernel", ENGINES)
def test_raise_equals_off_in_stream_fit(engine, use_kernel):
    d = {"experiment": {"data": {"source": "cosine", "seed": 2},
                        "solver": {"n_sweeps": 2, "engine": engine,
                                   "use_kernel": use_kernel}},
         "window": 128, "chunk": 32, "resweep_every": 64,
         "total_instances": 256}
    off = tapi.stream_fit(tapi.stream_spec_from_dict(d), device="cpu")
    d["experiment"]["backend"] = {"checks": "raise"}
    on = tapi.stream_fit(tapi.stream_spec_from_dict(d), device="cpu")
    assert len(on.records) == len(off.records) == 4
    for ro, rf in zip(on.records, off.records):
        for k in ("etas", "train_mse", "preq_mse", "bytes", "bytes_total"):
            assert ro[k] == rf[k], k
    assert torch.equal(on.weights, off.weights)


def test_stream_checks_name_the_relay(nan_codec):
    d = {"experiment": {"data": {"source": "cosine"},
                        "transport": {"codec": "nan_injector"},
                        "backend": {"checks": "raise"}},
         "window": 128, "chunk": 32, "resweep_every": 64,
         "total_instances": 128}
    with pytest.raises(CheckError, match="^" + RELAY_SITE + "$"):
        tapi.stream_fit(tapi.stream_spec_from_dict(d), device="cpu")


@pytest.mark.parametrize("engine", ["incremental", "fused", "dense"])
def test_raise_matches_reference_off_f64(engine):
    """The port in raise mode against repro.api in off mode, float64: fit
    and a 3-trial batch at 1e-10, bytes equal."""
    d = {"data": {"n_train": 200, "n_test": 100, "seed": 3}, "seed": 1,
         "solver": {"n_sweeps": 3, "engine": engine},
         "transport": {"codec": "int8_affine"}}
    jspec = japi.spec_from_dict(d)
    tspec = tapi.spec_from_dict({**d, "backend": {"checks": "raise"}})
    with f64():
        tres = tapi.fit(tspec, device="cpu")
        jres = japi.fit(jspec)
        trs = tapi.batch_fit(tspec, 3, device="cpu")
        jrs = japi.batch_fit(jspec, 3)
    for k in ("train_mse", "test_mse", "eta"):
        np.testing.assert_allclose(getattr(tres.history, k),
                                   getattr(jres.history, k), rtol=1e-10,
                                   err_msg=k)
        np.testing.assert_allclose(trs.stack(k), jrs.stack(k), rtol=1e-10,
                                   err_msg=k)
    assert tres.history.bytes_transmitted == jres.history.bytes_transmitted
    assert np.array_equal(trs.stack("bytes_transmitted"),
                          jrs.stack("bytes_transmitted"))


def test_stream_raise_matches_reference_off_f64():
    d = {"experiment": {"data": {"source": "cosine", "seed": 2},
                        "solver": {"n_sweeps": 2, "engine": "fused"}},
         "window": 128, "chunk": 32, "resweep_every": 64,
         "total_instances": 256}
    with f64():
        jres = japi.stream_fit(japi.stream_spec_from_dict(d))
        d["experiment"]["backend"] = {"checks": "raise"}
        tres = tapi.stream_fit(tapi.stream_spec_from_dict(d), device="cpu")
    for tr, jr in zip(tres.records, jres.records, strict=True):
        assert tr["bytes"] == jr["bytes"] and tr["sweeps"] == jr["sweeps"]
        for k in ("train_mse", "preq_mse", "eta"):
            np.testing.assert_allclose(tr[k], jr[k], rtol=1e-10, err_msg=k)


def test_shard_map_still_waits_for_a11():
    """A checked shard_map spec validates since A11a; what still raises
    names A11b: its compiled batch and a trial mesh of trial_devices > 1
    (on the local backend: shard_map with trial_devices is a SpecError)."""
    backend = tapi.BackendSpec(name="shard_map", checks="raise")
    backend.validate()
    with pytest.raises(tapi.NotPortedError, match=r"ROADMAP A11b\b"):
        tapi.batch_fit(tapi.ExperimentSpec(backend=backend), 2, device="cpu")
    local = tapi.ExperimentSpec(backend=tapi.BackendSpec(checks="raise",
                                                         trial_devices=2))
    with pytest.raises(tapi.NotPortedError, match=r"ROADMAP A11b\b"):
        tapi.batch_fit(local, 2, device="cpu")


# ---------------------------------------------------------------------- lint

LINT_CASES = {
    "implicit-dtype": (
        "import torch\nx = torch.zeros((3,), device='cpu')\n",
        "import torch\nx = torch.zeros((3,), dtype=torch.float32, device='cpu')\n"
        "y = torch.full((2,), 1.0, **meta)\n"),
    "implicit-device": (
        "import torch\nx = torch.arange(4, dtype=torch.int64)\n",
        "import torch\nx = torch.arange(4, dtype=torch.int64, device=dev)\n"
        "y = torch.zeros_like(x)\n"),
    "host-call-in-capture": (
        "import torch\nwith torch.cuda.graph(g):\n    out = f(a)\n"
        "    print(out.sum().item())\n",
        "import torch\nwith torch.cuda.graph(g):\n    out = f(a)\n"
        "print(out.sum().item())\n"),
    "mutable-static-field": (
        "import dataclasses\nfrom typing import List\n"
        "@dataclasses.dataclass(frozen=True)\nclass S:\n    xs: List[int]\n",
        "import dataclasses\nfrom typing import Tuple\n"
        "@dataclasses.dataclass(frozen=True)\nclass S:\n    xs: Tuple[int, ...]\n"),
    "registry-signature": (
        "@register_source('s')\ndef s(key, n, n_attrs, noise):\n    pass\n",
        "@register_source('s')\ndef s(key, n, n_attrs, noise, dtype, rho=0.5):\n"
        "    pass\n"),
    "foreign-import": (
        "import jax\nfrom repro.core import icoa\n",
        "import numpy\nfrom repro_torch.core import icoa\nimport reprolib\n"),
}


@pytest.mark.parametrize("rule", sorted(lint.RULES))
def test_lint_rule_fires_on_bad_and_not_on_good(rule):
    bad, good = LINT_CASES[rule]
    path = "src/repro_torch/case.py"
    hits = [v for v in lint.lint_source(bad, path) if v.rule == rule]
    assert hits and all(v.path == path for v in hits), rule
    assert lint.lint_source(good, path) == []
    # the same line, suppressed with its rule
    first = hits[0].line
    lines = bad.splitlines()
    lines[first - 1] += f"  # reprolint: disable={rule} -- a reason"
    assert not [v for v in lint.lint_source("\n".join(lines) + "\n", path)
                if v.rule == rule and v.line == first]


def test_foreign_import_holds_only_for_the_port():
    src = "import jax\n"
    assert [v.rule for v in lint.lint_source(src, "chip_smoke.py")] == \
        ["foreign-import"]
    assert lint.lint_source(src, "tests/test_torch_api.py") == []


def test_port_tree_lints_clean():
    assert lint.lint_paths([os.path.join(REPO, "src", "repro_torch"),
                            os.path.join(REPO, "chip_smoke.py")]) == []


def test_lint_cli_exit_codes(tmp_path):
    bad = tmp_path / "repro_torch" / "bad.py"
    bad.parent.mkdir()
    bad.write_text("import torch\nx = torch.ones((2,))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    cmd = [sys.executable, "-m", "repro_torch.analysis.lint"]
    out = subprocess.run(cmd + [str(bad)], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 1 and "[implicit-dtype]" in out.stdout
    ok = subprocess.run(cmd + [os.path.join(REPO, "chip_smoke.py")], env=env,
                        capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0 and "clean" in ok.stdout, ok.stdout + ok.stderr


@pytest.mark.parametrize("stem", ["mutable_static_field", "registry_signature"])
@pytest.mark.parametrize("kind", ["bad", "ok"])
def test_kept_rules_match_the_reference_on_its_fixtures(stem, kind):
    path = os.path.join(FIXTURES, f"{stem}_{kind}.py")
    rule = stem.replace("_", "-")
    want = [(v.line, v.rule) for v in jlint.lint_file(path) if v.rule == rule]
    got = [(v.line, v.rule) for v in lint.lint_file(path) if v.rule == rule]
    assert got == want
    assert bool(got) == (kind == "bad")


# ---------------------------------------------------------------- recompile


def test_counter_sees_records_only_inside_its_scope():
    recompile.record("build:gram")                 # no scope: dropped
    with recompile.count_compilations() as outer:
        recompile.record("build:gram")
        with recompile.count_compilations() as inner:
            recompile.record("capture:minimax._descend_graphed")
        recompile.record("load:gram")
    recompile.record("load:gram")
    assert inner.counts == {"capture:minimax._descend_graphed": 1}
    assert outer.counts == {"build:gram": 1, "load:gram": 1,
                            "capture:minimax._descend_graphed": 1}
    assert outer.total == 3
    assert outer.by_kind("build") == {"gram": 1}
    assert outer.by_kind("capture") == {"minimax._descend_graphed": 1}


def test_check_budget_verdicts():
    budget = {"chip_smoke": {"max_compiles": 10}}
    assert recompile.check_budget("chip_smoke", 10, budget) == []
    assert "exceed the budget" in recompile.check_budget("chip_smoke", 11,
                                                         budget)[0]
    assert "no budget" in recompile.check_budget("other", 1, budget)[0]


def test_checked_in_budget_has_the_chip_smoke_entry(tmp_path):
    budget = recompile.load_budget()
    assert int(budget["chip_smoke"]["max_compiles"]) > 0
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"chip_smoke": {"max_compiles": 5}}))
    with pytest.raises(ValueError, match="entries"):
        recompile.load_budget(str(bad))


def test_write_audit_roundtrip_and_absorb(tmp_path, monkeypatch):
    log = recompile.CompilationLog()
    for name in ("build:gram", "build:gram", "capture:x"):
        log.record(name)
    path = tmp_path / "audit.json"
    recompile.write_audit(str(path), "chip_smoke", log)
    assert json.loads(path.read_text()) == {
        "entry": "chip_smoke", "total": 3,
        "counts": {"build:gram": 2, "capture:x": 1}}
    recompile.absorb_counts({"load:gram": 1})      # off: no-op
    monkeypatch.setattr(recompile, "_installed", log)
    recompile.absorb_counts({"load:gram": 2, "build:gram": 1})
    assert log.counts == {"build:gram": 3, "capture:x": 1, "load:gram": 2}


def test_install_from_env_writes_at_exit_and_check_cli(tmp_path, monkeypatch):
    monkeypatch.delenv(recompile.ENV_VAR, raising=False)
    assert recompile.install_from_env("probe") is None
    audit, budget = tmp_path / "audit.json", tmp_path / "budget.json"
    script = ("from repro_torch.analysis import recompile\n"
              "recompile.install_from_env('probe')\n"
              "recompile.record('build:gram')\n"
              "recompile.record('capture:minimax._descend_graphed')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env[recompile.ENV_VAR] = str(audit)
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    data = json.loads(audit.read_text())
    assert data["entry"] == "probe" and data["total"] == 2
    cmd = [sys.executable, "-m", "repro_torch.analysis.recompile", "check",
           str(audit), "--budget", str(budget)]
    budget.write_text(json.dumps({"entries": {"probe": {"max_compiles": 2}}}))
    ok = subprocess.run(cmd, env=env, capture_output=True, text=True,
                        timeout=120)
    assert ok.returncode == 0 and "within budget" in ok.stdout, ok.stderr
    budget.write_text(json.dumps({"entries": {"probe": {"max_compiles": 1}}}))
    bad = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=120)
    assert bad.returncode == 1 and "BUDGET VIOLATION" in bad.stderr
