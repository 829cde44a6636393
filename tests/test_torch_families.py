"""The rff and mlp agent families and the C library's float32 sin / cos /
atan (repro_torch.data.libm) against the JAX package.

  * libm.sinf / cosf / atanf against the C library's (ctypes) on 1.2e6
    float32 values over the whole range (0 mismatches), and against
    jax.jit(jnp.sin / cos / arctan) on the same values (XLA's CPU code
    calls the C library); the Friedman-1, Friedman-3 and cosine float32
    datasets then equal the JAX package's bit for bit;
  * rff: Omega and the phases bit for bit (float32 and float64), the
    float32 features bit for bit against the JAX package's feature map;
    fit / predict in float64 at 1e-10 / 1e-12; in float32 the ridge solve
    on 64 nearly collinear features of one column amplifies the two
    libraries' last bits of the Gram's sums, so float32 is held to the
    JAX package's own spread (below);
  * mlp: init bit for bit (float32; float64 within the normals' 3 ulp),
    the JAX package's dtypes (float64 weights beside float32 biases under
    x64); fit within 4x the JAX package's own spread: how far its own fit
    moves when its targets move by one ulp (all scaled by 1 + eps, or each
    by a seeded 1 + k eps, k in {-1, 0, 1}; eps 2^-23 in float32, 1e-15
    in float64, where the float32 biases carry float32's spread);
  * dict params through convert.params_from_numpy and the Result
    checkpoint in both directions, mixed dtypes kept.
The from-spec fits and the fig1 cell are in tests/test_torch_families_fit.py.
"""
import ctypes
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.agents import MLPFamily as JMLP
from repro.agents import RFFFamily as JRFF
from repro.data import sources as jsrc
from repro_torch import api as tapi
from repro_torch import convert, prng
from repro_torch.agents import MLPFamily, RFFFamily
from repro_torch.data import libm
from repro_torch.data import sources as tsrc

_LIBM = ctypes.CDLL("libm.so.6")
for _name in ("sinf", "cosf", "atanf"):
    getattr(_LIBM, _name).restype = ctypes.c_float
    getattr(_LIBM, _name).argtypes = [ctypes.c_float]


def _values() -> np.ndarray:
    """1.2e6 float32 values over the whole range: each reduction branch,
    the boundaries, signed zeros, subnormals, infinities and nan."""
    rng = np.random.default_rng(0)
    n = 200_000
    parts = [rng.uniform(-1, 1, n), rng.uniform(-10, 10, n),
             rng.uniform(-130, 130, n), rng.uniform(-1e6, 1e6, n),
             np.exp(rng.uniform(-100, 88, n)) * rng.choice([-1, 1], n),
             rng.uniform(-1e-3, 1e-3, n)]
    edges = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 3e38, -3e38,
             120.0, -120.0, 0.75, 119.99999, np.pi / 4, 2.0 ** -12, 2.0 ** 25,
             2.0 ** -29, 0.4375, 1.1875, 2.4375, 0.6875]
    return np.concatenate(parts + [np.asarray(edges)]).astype(np.float32)


@pytest.fixture(scope="module")
def values():
    return _values()


def _same_bits(got: np.ndarray, want: np.ndarray) -> int:
    """Count of elements whose bits differ (any nan equals any nan)."""
    same = (got.view(np.int32) == want.view(np.int32)) | (np.isnan(got) & np.isnan(want))
    return int(np.sum(~same))


@pytest.mark.parametrize("name", ["sinf", "cosf", "atanf"])
def test_libm_float32_bit_for_bit(values, name):
    got = getattr(libm, name)(torch.from_numpy(values)).numpy()
    c_fn = getattr(_LIBM, name)
    want = np.frompyfunc(lambda v: c_fn(float(v)), 1, 1)(values).astype(np.float32)
    assert values.size >= 10 ** 6
    assert _same_bits(got, want) == 0
    jfn = {"sinf": jnp.sin, "cosf": jnp.cos, "atanf": jnp.arctan}[name]
    assert _same_bits(got, np.asarray(jax.jit(jfn)(values))) == 0


def test_libm_float64_and_dtype_routing():
    x = torch.linspace(-50, 50, 1001, dtype=torch.float64)
    assert torch.equal(libm.sin(x), torch.sin(x))
    assert torch.equal(libm.cos(x), torch.cos(x))
    assert torch.equal(libm.atan(x), torch.atan(x))
    with pytest.raises(ValueError, match="float32"):
        libm.sinf(x)


@pytest.mark.parametrize("source,kw", [
    ("friedman1", {}), ("friedman3", {}),
    ("cosine", dict(n_attrs=6, options=(("freq", 1.5),)))])
@pytest.mark.parametrize("seed", [0, 3])
def test_float32_outcomes_bit_for_bit(source, kw, seed):
    want = jsrc.make_dataset(source, 600, 300, seed, noise=0.05, **kw)
    got = tsrc.make_dataset(source, 600, 300, seed, noise=0.05,
                            dtype=torch.float32, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------- rff


def _xy(n, c, dt, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, c)) * 1.5).astype(dt)
    y = (np.sin(2 * x[:, 0]) + 0.1 * rng.standard_normal(n)).astype(dt)
    return x, y


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("c", [1, 2])
def test_rff_omega_and_features_bit_for_bit(x64, c):
    dt, tdt = (np.float64, torch.float64) if x64 else (np.float32, torch.float32)
    x, _ = _xy(300, c, dt)
    with jax.enable_x64(x64):
        jf = JRFF(n_cols=c, seed=4)
        om, ph = (np.asarray(a) for a in jf._omega())
        feats = np.asarray(jf._features(jnp.asarray(x)))
    tf = RFFFamily(n_cols=c, seed=4)
    tom, tph = tf._omega(tdt)
    np.testing.assert_array_equal(tom.numpy(), om)
    np.testing.assert_array_equal(tph.numpy(), ph)
    got = tf._features(torch.from_numpy(x)).numpy()
    if x64:          # XLA's float64 cos and torch's differ in the last bit
        np.testing.assert_allclose(got, feats, rtol=0, atol=4e-16)
    else:
        np.testing.assert_array_equal(got, feats)
    init = tf.init(prng.split(prng.PRNGKey(0), 3))
    assert init.shape == (3, 64) and init.dtype == torch.float32 and not init.any()


def test_rff_fit_predict_f64():
    x, y = _xy(400, 1, np.float64)
    with jax.enable_x64(True):
        jf = JRFF(n_cols=1)
        jp = jf.fit(jf.init(None), jnp.asarray(x), jnp.asarray(y))
        jpred = np.asarray(jf.predict(jp, jnp.asarray(x)))
    tf = RFFFamily(n_cols=1)
    tp = tf.fit(tf.init(prng.PRNGKey(0)), torch.from_numpy(x), torch.from_numpy(y))
    assert tp.dtype == torch.float64
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(jp)).max())
    np.testing.assert_allclose(tf.predict(tp, torch.from_numpy(x)).numpy(), jpred,
                               rtol=0, atol=1e-12 * np.abs(jpred).max())
    # batched agents (D, N, C) predict as one agent at a time
    xs = torch.from_numpy(np.stack([x, 0.5 * x]))
    ys = torch.from_numpy(np.stack([y, y]))
    pred = tf.predict(tf.fit(None, xs, ys), xs)
    for a in range(2):
        torch.testing.assert_close(
            pred[a], tf.predict(tf.fit(None, xs[a], ys[a]), xs[a]),
            rtol=0, atol=1e-10)


def _spread(fit_predict, arrays, eps, dt):
    """The largest move of fit_predict's output over the JAX package's own
    runs on `arrays` moved by one ulp: all scaled by 1 + eps, or each by a
    seeded 1 + k eps, k in {-1, 0, 1} (three draws)."""
    base = fit_predict(*arrays)
    moves = [[a * dt(1 + eps) for a in arrays]]
    for seed in range(3):
        rng = np.random.default_rng(seed)
        moves.append([a * (1 + dt(eps) * rng.integers(-1, 2, a.shape).astype(dt))
                      for a in arrays])
    return base, max(np.max(np.abs(fit_predict(*m) - base)) for m in moves)


def test_rff_fit_predict_f32_within_jax_spread():
    x, y = _xy(400, 1, np.float32)
    jf = JRFF(n_cols=1)

    def jfp(xx, yy):
        p = jf.fit(jf.init(None), jnp.asarray(xx), jnp.asarray(yy))
        return np.asarray(jf.predict(p, jnp.asarray(x)))

    want, spread = _spread(jfp, [x, y], 2.0 ** -23, np.float32)
    tf = RFFFamily(n_cols=1)
    got = tf.predict(tf.fit(None, torch.from_numpy(x), torch.from_numpy(y)),
                     torch.from_numpy(x)).numpy()
    gap = np.max(np.abs(got - want))
    # where the gap comes from, on bit-identical features: each package's
    # Gram (summation order) through the other's float32 solve (LU order)
    phi = tf._features(torch.from_numpy(x))
    eye = torch.eye(tf.n_features)
    grams = {"port": ((phi.T @ phi + tf.ridge * eye).numpy(),
                      (phi.T @ torch.from_numpy(y)).numpy())}
    jphi = jf._features(jnp.asarray(x))
    grams["jax"] = (np.asarray(jphi.T @ jphi + tf.ridge * jnp.eye(tf.n_features)),
                    np.asarray(jphi.T @ jnp.asarray(y)))
    jbeta = np.asarray(jnp.linalg.solve(*map(jnp.asarray, grams["jax"])))
    gram_gap = np.max(np.abs(phi.numpy() @ (np.asarray(jnp.linalg.solve(
        *map(jnp.asarray, grams["port"]))) - jbeta)))
    solve_gap = np.max(np.abs(phi.numpy() @ (torch.linalg.solve(
        *map(torch.tensor, grams["jax"])).numpy() - jbeta)))
    print(f"\nrff float32 predictions: gap {gap:.3e}, the JAX package's "
          f"one-ulp spread {spread:.3e}; cond(Gram) "
          f"{np.linalg.cond(grams['jax'][0].astype(np.float64)):.3e}, the port's "
          f"Gram alone moves them {gram_gap:.3e}, the port's solve alone "
          f"{solve_gap:.3e}")
    assert spread > 0 and gap <= 4 * spread


# ---------------------------------------------------------------------- mlp


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_mlp_init_matches_jax(x64):
    tdt = torch.float64 if x64 else torch.float32
    with jax.enable_x64(x64):
        jf = JMLP(n_cols=2, hidden=16)
        jp = jax.vmap(jf.init)(jax.random.split(jax.random.PRNGKey(3), 5))
        jp = {k: np.asarray(v) for k, v in jp.items()}
    tp = MLPFamily(n_cols=2, hidden=16).init(prng.split(prng.PRNGKey(3), 5), tdt)
    assert sorted(tp) == sorted(jp)
    for k, v in tp.items():
        assert v.numpy().dtype == jp[k].dtype and v.shape == jp[k].shape, k
        if x64:      # float64 normals: within 3 ulp of jax's (prng)
            np.testing.assert_allclose(v.numpy(), jp[k], rtol=7e-16, atol=0)
        else:
            np.testing.assert_array_equal(v.numpy(), jp[k])
    assert tp["b1"].dtype == torch.float32 and not tp["b1"].any()


@pytest.mark.parametrize("x64,hidden,steps", [
    (False, 8, 30), (True, 8, 30), (False, 32, 200)],
    ids=["f32-small", "f64-small", "f32-default"])
def test_mlp_fit_within_jax_spread(x64, hidden, steps):
    """fit of 4 agents at once (batched) against the JAX package's vmapped
    fit: predictions within 4x the JAX package's own spread over targets
    moved by one ulp.  The default size (hidden 32, 200 steps) once."""
    dt, tdt = (np.float64, torch.float64) if x64 else (np.float32, torch.float32)
    eps = 1e-15 if x64 else 2.0 ** -23
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 200, 1)).astype(dt)
    y = np.sin(2 * x[..., 0]).astype(dt)
    with jax.enable_x64(x64):
        jf = JMLP(n_cols=1, hidden=hidden, fit_steps=steps)
        p0 = jax.vmap(jf.init)(jax.random.split(jax.random.PRNGKey(2), 4))
        fit = jax.jit(jax.vmap(lambda p, xx, yy: jf.predict(jf.fit(p, xx, yy), xx)))

        def jfp(yy):
            return np.asarray(fit(p0, jnp.asarray(x), jnp.asarray(yy)))

        want, spread = _spread(jfp, [y], eps, dt)
        jfit = jax.vmap(jf.fit)(p0, jnp.asarray(x), jnp.asarray(y))
    tf = MLPFamily(n_cols=1, hidden=hidden, fit_steps=steps)
    tp0 = tf.init(prng.split(prng.PRNGKey(2), 4), tdt)
    tp = tf.fit(tp0, torch.from_numpy(x), torch.from_numpy(y))
    assert {k: v.numpy().dtype for k, v in tp.items()} == {
        k: np.asarray(v).dtype for k, v in jfit.items()}
    for k in tp0:                                  # the inputs stay untouched
        assert not tp0[k].requires_grad
    got = tf.predict(tp, torch.from_numpy(x)).numpy()
    gap = np.max(np.abs(got - want))
    print(f"\nmlp x64={x64} hidden={hidden} steps={steps}: gap {gap:.3e}, the "
          f"JAX package's one-ulp spread {spread:.3e}")
    assert spread > 0 and gap <= 4 * spread


# ------------------------------------------------------ conversion and io


def test_mlp_params_convert_and_checkpoint_round_trip(tmp_path):
    """The JAX package's dict params cross over with their dtypes; a Result
    saved by either package loads in the other with the same leaves."""
    d = {"data": {"n_train": 120, "n_test": 60, "seed": 1},
         "agent": {"family": "mlp", "options": [["hidden", 6], ["fit_steps", 5]]},
         "solver": {"n_sweeps": 1}}
    with jax.enable_x64(True):
        jres = japi.fit(japi.spec_from_dict(d))
    japi.clear_dataset_cache()
    jp = {k: np.asarray(v) for k, v in jres.params.items()}
    tp = convert.params_from_numpy(jp)
    assert {k: v.dtype for k, v in tp.items()}["b1"] == torch.float32
    assert tp["w1"].dtype == torch.float64
    x = np.random.default_rng(0).standard_normal((40, 5))
    with jax.enable_x64(True):
        want = np.asarray(jres.predict(jnp.asarray(x)))
    tres = tapi.Result(spec=tapi.spec_from_dict(d), family=MLPFamily(n_cols=1, hidden=6,
                                                                     fit_steps=5),
                       params=tp, weights=torch.from_numpy(np.asarray(jres.weights)),
                       f=torch.from_numpy(np.asarray(jres.f)), history=tapi.History())
    np.testing.assert_allclose(tres.predict(torch.from_numpy(x)).numpy(), want,
                               rtol=1e-6, atol=1e-7)
    # JAX -> port (float32 load, as both packages load)
    jres32 = japi.fit(japi.spec_from_dict(d))
    japi.clear_dataset_cache()
    jres32.save(str(tmp_path / "j"))
    back = tapi.load(str(tmp_path / "j"), device="cpu", with_data=False)
    for k, v in jres32.params.items():
        np.testing.assert_array_equal(back.params[k].numpy(), np.asarray(v))
        assert back.params[k].numpy().dtype == np.asarray(v).dtype
    # port -> JAX, and back into the port
    tres2 = tapi.fit(tapi.spec_from_dict(d), device="cpu")
    tres2.save(str(tmp_path / "t"))
    jback = japi.load(str(tmp_path / "t"), with_data=False)
    japi.clear_dataset_cache()
    tback = tapi.load(str(tmp_path / "t"), device="cpu", with_data=False)
    for k, v in tres2.params.items():
        np.testing.assert_array_equal(np.asarray(jback.params[k]), v.numpy())
        assert torch.equal(tback.params[k], v)
    assert tback.history.as_dict() == tres2.history.as_dict()
