"""repro_torch.core.minimax against repro.core.minimax, float64 (JAX under
jax.enable_x64), the same numpy inputs on both sides, at 1e-12:

  * robust_objective;
  * robust_weights at D in {3, 5, 20} and delta in {0, 0.01, 0.1, one above
    lambda_min(A0)}, from the closed-form start, from a given a_init and
    from a wild a_init (the guard falls back to uniform weights), 80 steps.
    One case cannot hold weights at 1e-12: delta = 0 from the closed-form
    start begins AT the optimum, where every iterate's objective ties to
    the last bit, so the best-iterate rule (a strict <) picks among
    iterates that differ by ~1e-10 on a last-bit difference of the sums.
    There the objective value is held at 1e-12 and the weights at 1e-9;
  * the batched form (B, K, D) equals the row-by-row form;
  * _t975, delta_opt (m = 5 at alpha = 800, t_correct) and upper_bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import minimax as jmm
from repro_torch.core import minimax as tmm

STEPS = 80


@pytest.fixture(autouse=True)
def x64():
    with jax.enable_x64(True):
        yield


def _a0(d, seed=0):
    """A residual second-moment matrix: correlated rows, as ICOA's are."""
    rng = np.random.default_rng(seed)
    n = 4 * d
    r = 0.5 * rng.standard_normal((d, n)) + rng.standard_normal(n)
    return r @ r.T / n


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _deltas(a0):
    return {"0": 0.0, "0.01": 0.01, "0.1": 0.1,
            "above_lmin": float(np.linalg.eigvalsh(a0)[0]) + 0.05}


@pytest.mark.parametrize("d", [3, 5, 20])
def test_robust_objective_matches_jax(d):
    a0 = _a0(d, seed=d)
    a = np.random.default_rng(1).standard_normal(d)
    for delta in _deltas(a0).values():
        got = tmm.robust_objective(torch.from_numpy(a), torch.from_numpy(a0), delta)
        want = jmm.robust_objective(jnp.asarray(a), jnp.asarray(a0), delta)
        assert abs(float(got) - float(want)) <= 1e-12 * abs(float(want))


@pytest.mark.parametrize("start", ["closed_form", "a_init", "wild"])
@pytest.mark.parametrize("delta", ["0", "0.01", "0.1", "above_lmin"])
@pytest.mark.parametrize("d", [3, 5, 20])
def test_robust_weights_match_jax(d, delta, start):
    a0 = _a0(d, seed=d + 1)
    dl = _deltas(a0)[delta]
    rng = np.random.default_rng(d)
    near = np.full(d, 1.0 / d) + 0.05 * rng.standard_normal(d)
    a_init = {"closed_form": None, "a_init": near / near.sum(),
              "wild": np.full(d, 5e3)}[start]
    want = np.asarray(jmm.robust_weights(
        jnp.asarray(a0), dl, steps=STEPS,
        a_init=None if a_init is None else jnp.asarray(a_init)))
    got = tmm.robust_weights(
        torch.from_numpy(a0), dl, steps=STEPS,
        a_init=None if a_init is None else torch.from_numpy(a_init))
    assert got.dtype == torch.float64
    obj_t = float(tmm.robust_objective(got, torch.from_numpy(a0), dl))
    obj_j = float(jmm.robust_objective(jnp.asarray(want), jnp.asarray(a0), dl))
    assert abs(obj_t - obj_j) <= 1e-12 * abs(obj_j)
    knife_edge = delta == "0" and start == "closed_form"
    assert _rel(got.numpy(), want) <= (1e-9 if knife_edge else 1e-12)
    np.testing.assert_allclose(float(got.sum()), 1.0, rtol=1e-12)


def test_wild_start_falls_back_to_uniform():
    """A non-finite or huge start is replaced by uniform weights: the same
    result as starting there."""
    a0 = torch.from_numpy(_a0(5, seed=3))
    uniform = tmm.robust_weights(a0, 0.05, steps=STEPS,
                                 a_init=torch.full((5,), 0.2, dtype=torch.float64))
    for wild in (torch.full((5,), 5e3, dtype=torch.float64),
                 torch.tensor([0.2, float("nan"), 0.2, 0.2, 0.4], dtype=torch.float64)):
        assert torch.equal(tmm.robust_weights(a0, 0.05, steps=STEPS, a_init=wild),
                           uniform)


def test_batched_equals_row_by_row():
    """(B, K, D) problems in one call: each row is its own single call."""
    b, k, d = 2, 3, 5
    a0 = np.stack([np.stack([_a0(d, seed=10 * i + j) for j in range(k)])
                   for i in range(b)])
    rng = np.random.default_rng(4)
    a_init = np.full((b, k, d), 1.0 / d) + 0.05 * rng.standard_normal((b, k, d))
    got = tmm.robust_weights(torch.from_numpy(a0), 0.05, steps=STEPS,
                             a_init=torch.from_numpy(a_init))
    obj = tmm.robust_objective(got, torch.from_numpy(a0), 0.05)
    assert got.shape == (b, k, d) and obj.shape == (b, k)
    for i in range(b):
        for j in range(k):
            one = tmm.robust_weights(torch.from_numpy(a0[i, j]), 0.05,
                                     steps=STEPS,
                                     a_init=torch.from_numpy(a_init[i, j]))
            assert _rel(got[i, j].numpy(), one.numpy()) <= 1e-14
            want = jmm.robust_weights(jnp.asarray(a0[i, j]), 0.05, steps=STEPS,
                                      a_init=jnp.asarray(a_init[i, j]))
            assert _rel(got[i, j].numpy(), want) <= 1e-12


def test_t975_and_delta_opt_match_jax():
    for nu in (0.5, 1.0, 3.0, 5.0, 30.0, 1e4):
        assert tmm._t975(nu) == jmm._t975(nu)
    for alpha, n, s2 in [(1.0, 2000, 0.3), (100.0, 2000, 0.3), (800.0, 4000, 1.7),
                         (100.0, 262144, 0.05), (5.0, 10, 4.0)]:
        for tc in (False, True):
            assert tmm.delta_opt(alpha, n, s2, t_correct=tc) == jmm.delta_opt(
                alpha, n, s2, t_correct=tc)
    # m = 5 at the paper's alpha = 800, N = 4000: the t quantile is larger
    assert tmm.delta_opt(800.0, 4000, 1.0, t_correct=True) > tmm.delta_opt(
        800.0, 4000, 1.0)


@pytest.mark.parametrize("alpha", [1.0, 20.0, 100.0])
def test_upper_bound_matches_jax(alpha):
    a_ini = _a0(5, seed=7)
    got = tmm.upper_bound(torch.from_numpy(a_ini), alpha, 2000, steps=STEPS)
    want = jmm.upper_bound(jnp.asarray(a_ini), alpha, 2000, steps=STEPS)
    assert abs(got - want) <= 1e-12 * abs(want)


def _rand_cov_f32(seed, d):
    """tests/test_minimax.py's draw (float32, jax.random from PRNGKey(seed))."""
    with jax.enable_x64(False):
        m = jax.random.normal(jax.random.PRNGKey(seed), (d, 2 * d))
        return np.asarray(m @ m.T / (2 * d) + 1e-4 * jnp.eye(d))


@pytest.mark.parametrize("seed,d,delta", [(3288, 2, 0.1), (1341, 2, 0.05)])
def test_robust_weights_worse_than_uniform_draws_match_jax(seed, d, delta):
    """ROADMAP C8, pinned: two draws of the JAX package's hypothesis test
    test_minimax.py::test_robust_weights_feasible_and_no_worse_than_uniform
    on which its robust weights (200 steps, float32) are worse than uniform
    weights, so that test fails whenever it draws them.  The fault is the
    reference's: its PGD starts from the unprotected closed form and keeps
    its best iterate, and the uniform weights are never a candidate
    (repro/core/minimax.py:49-73).  The port keeps the reference's
    behaviour, so its weights equal the reference's (2e-6, float32) and are
    worse than uniform on the same draws."""
    a0 = _rand_cov_f32(seed, d)
    assert a0.dtype == np.float32
    with jax.enable_x64(False):
        want = np.asarray(jmm.robust_weights(jnp.asarray(a0), delta, steps=200))
        uni = jnp.ones((d,), jnp.float32) / d
        j_obj = float(jmm.robust_objective(jnp.asarray(want), jnp.asarray(a0), delta))
        j_uni = float(jmm.robust_objective(uni, jnp.asarray(a0), delta))
    ta0 = torch.from_numpy(a0)
    got = tmm.robust_weights(ta0, delta, steps=200)
    assert got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - want)) <= 2e-6
    t_obj = float(tmm.robust_objective(got, ta0, delta))
    t_uni = float(tmm.robust_objective(torch.full((d,), 1.0 / d, dtype=torch.float32), ta0,
                                       delta))
    assert j_obj > j_uni + 1e-5 and t_obj > t_uni + 1e-5
