"""repro_torch.prng against jax.random (jax 0.9.0's defaults: threefry2x32,
jax_threefry_partitionable=True): bit for bit.

  * PRNGKey, split (num 2, 3, 5) and bits, as uint32 words, for seeds
    {0, 1, 7, 2**31 - 1} and several shapes;
  * permutation as integers for n in {2, 5, 20, 2000, 65537, 262144} (one
    sort round up to n = 1625, two above: the round count is pinned too);
  * a batch of keys (B, 2) gives each key's own result;
  * covariance.subsample_indices draws the JAX package's subsample;
  * the samplers: 64-bit bits (jax.random.bits(..., jnp.uint64) under
    x64), uniform in float32 and float64 (the latter from 64-bit words, as
    under jax.enable_x64), with and without minval/maxval, and fold_in, all
    bit for bit; XLA's float32 log and log1p, erf_inv and normal in
    float32 bit for bit; normal within 3 ulp in float64 (>= 99.95%
    bit-equal; measured at most 3 over 4 x 1e6 draws, 99.996% equal): the
    C library's log under XLA and torch.log differ in the last bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import covariance as jcov
from repro_torch import prng
from repro_torch.core import covariance as tcov

SEEDS = (0, 1, 7, 2**31 - 1)


def _u32(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    assert a.min() >= 0 and a.max() <= 0xFFFFFFFF
    return a.astype(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_match_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(_u32(tk), np.asarray(jk))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(_u32(prng.split(tk, num)),
                                      np.asarray(jax.random.split(jk, num)))
    # a split of a split: the key chain of a run
    k2 = jax.random.split(jax.random.split(jk, 3)[0], 3)
    np.testing.assert_array_equal(
        _u32(prng.split(prng.split(tk, 3)[0], 3)), np.asarray(k2))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 4), (2, 3, 5), (1000,)])
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_match_jax(seed, shape):
    np.testing.assert_array_equal(
        _u32(prng.bits(prng.PRNGKey(seed), shape)),
        np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape)))


@pytest.mark.parametrize("n", [2, 5, 20, 2000, 65537, 262144])
@pytest.mark.parametrize("seed", SEEDS)
def test_permutation_matches_jax(seed, n):
    """At n = 262144 about 8 of the 32-bit sort keys of a round collide, so
    the sort's stability shows."""
    got = prng.permutation(prng.PRNGKey(seed), n).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n)))


def test_shuffle_rounds():
    assert [prng.shuffle_rounds(n) for n in (1, 2, 1625, 1626, 262144)] == [
        0, 1, 1, 2, 2]


def test_batched_keys_equal_per_key():
    seeds = [3, 4, 9]
    keys = prng.PRNGKey(seeds)
    assert keys.shape == (3, 2)
    perm = prng.permutation(keys, 2000)
    splits = prng.split(keys, 3)
    words = prng.bits(keys, (4, 5))
    for b, seed in enumerate(seeds):
        one = prng.PRNGKey(seed)
        assert torch.equal(keys[b], one)
        assert torch.equal(perm[b], prng.permutation(one, 2000))
        assert torch.equal(splits[b], prng.split(one, 3))
        assert torch.equal(words[b], prng.bits(one, (4, 5)))


@pytest.mark.parametrize("n,alpha", [(2000, 100.0), (600, 20.0), (10, 100.0)])
def test_subsample_indices_match_jax(n, alpha):
    key = jax.random.split(jax.random.PRNGKey(6), 2)[1]
    tkey = prng.split(prng.PRNGKey(6))[1]
    got = tcov.subsample_indices(tkey, n, alpha)
    want = np.asarray(jcov.subsample_indices(key, n, alpha))
    assert got.shape == (jcov.subsample_size(n, alpha),)
    np.testing.assert_array_equal(got.numpy(), want)
    both = tcov.subsample_indices(torch.stack([tkey, prng.PRNGKey(2)]), n, alpha)
    assert torch.equal(both[0], got)


# ------------------------------------------------------------- the samplers


def _ulp(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Distance in units in the last place between two float arrays."""
    it = np.int32 if got.dtype == np.float32 else np.int64
    a, b = (x.view(it).astype(np.int64) for x in (got, want))
    lo = np.iinfo(it).min
    a, b = np.where(a < 0, lo - a, a), np.where(b < 0, lo - b, b)
    return np.abs(a - b)


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 4), (1000,)])
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_64_match_jax(seed, shape):
    with jax.enable_x64(True):
        want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape,
                                          jnp.uint64))
    got = prng.bits(prng.PRNGKey(seed), shape, width=64).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), want)


RANGES = [(0.0, 1.0), (1.0, 100.0), (40.0 * np.pi, 560.0 * np.pi),
          (1.0, 11.0), (-3.0, 0.5)]


@pytest.mark.parametrize("bounds", RANGES, ids=lambda b: f"{b[0]:.3g}-{b[1]:.3g}")
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax(seed, x64, bounds):
    """jax's CPU code scales with a fused multiply-add; the port rounds the
    same way, so every range is bit for bit."""
    lo, hi = bounds
    dtype = torch.float64 if x64 else torch.float32
    with jax.enable_x64(x64):
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (3, 700),
                                             minval=lo, maxval=hi))
    got = prng.uniform(prng.PRNGKey(seed), (3, 700), dtype, lo, hi).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("data", [0, 1, 5, 12345, 2**31, 2**32 - 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_matches_jax(seed, data):
    key = prng.split(prng.PRNGKey(seed), 3)[2]
    jkey = jax.random.split(jax.random.PRNGKey(seed), 3)[2]
    np.testing.assert_array_equal(_u32(prng.fold_in(key, data)),
                                  np.asarray(jax.random.fold_in(jkey, data)))
    # a fold_in chain, as a fault trace draws (seed, round, agent)
    np.testing.assert_array_equal(
        _u32(prng.fold_in(prng.fold_in(key, 3), data)),
        np.asarray(jax.random.fold_in(jax.random.fold_in(jkey, 3), data)))


def test_erf_inv_f32_within_2ulp_of_xla():
    """Bit for bit (within 0 ulp), over the normal sampler's inputs."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (100_000,),
                                      minval=lo, maxval=1.0))
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(u)))
    np.testing.assert_array_equal(prng.erf_inv(torch.from_numpy(u.copy())).numpy(),
                                  want)
    assert torch.equal(prng.erf_inv(torch.tensor([-1.0, 1.0])),
                       torch.tensor([-np.inf, np.inf]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_erf_inv_in_chunks_gives_the_same_bits(monkeypatch, dtype):
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = prng.uniform(prng.PRNGKey(5), (3, 1001), dtype, lo, 1.0)
    whole = prng.erf_inv(u)
    monkeypatch.setattr(prng, "_CPU_CHUNK", 256)
    assert torch.equal(prng.erf_inv(u), whole)


@pytest.mark.parametrize("fn", ["log", "log1p"])
def test_log_f32_matches_xla(fn):
    """XLA's CPU log (Cephes' logf) and log1p in float32, bit for bit, over
    (0, 1], (0, 1e4) and log1p's small branch |a| < sqrt(2) - 1."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(0, 1, 100_000), 10 ** rng.uniform(-30, 4, 50_000),
                        [1.0, 2.0 ** -126, 1e-38]]).astype(np.float32)
    if fn == "log1p":
        x = np.concatenate([x - 1, rng.uniform(-0.42, 0.42, 50_000)]).astype(np.float32)
        got = prng._log1p(torch.from_numpy(x))
    else:
        got = prng._log32(torch.from_numpy(x))
    want = np.asarray(jax.jit(getattr(jnp, fn))(x))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("x64,max_ulp,min_equal", [(False, 0, 1.0),
                                                   (True, 3, 0.9995)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("seed", (0, 7))
def test_normal_within_ulp_bound_of_jax(seed, x64, max_ulp, min_equal):
    dtype = torch.float64 if x64 else torch.float32
    with jax.enable_x64(x64):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                            (100_000,)))
    got = prng.normal(prng.PRNGKey(seed), (100_000,), dtype).numpy()
    assert got.dtype == want.dtype
    d = _ulp(got, want)
    assert d.max() <= max_ulp and (d == 0).mean() >= min_equal, (
        d.max(), (d == 0).mean())


def test_samplers_map_over_key_stacks():
    keys = prng.split(prng.PRNGKey(11), 3)
    for dtype in (torch.float32, torch.float64):
        u = prng.uniform(keys, (4, 50), dtype, 1.0, 11.0)
        z = prng.normal(keys, (60,), dtype)
        assert u.shape == (3, 4, 50) and z.shape == (3, 60)
        for b in range(3):
            assert torch.equal(u[b], prng.uniform(keys[b], (4, 50), dtype,
                                                  1.0, 11.0))
            assert torch.equal(z[b], prng.normal(keys[b], (60,), dtype))
    folded = prng.fold_in(keys, 9)
    for b in range(3):
        assert torch.equal(folded[b], prng.fold_in(keys[b], 9))
    w = prng.bits(keys, (5,), width=64)
    assert torch.equal(w[1], prng.bits(keys[1], (5,), width=64))


def test_out_of_range_seeds_and_data_raise():
    with pytest.raises(ValueError, match="seeds must be >= 0"):
        prng.PRNGKey(-1)
    with pytest.raises(ValueError, match="seeds must be >= 0"):
        prng.PRNGKey([3, -2])
    for data in (-1, 2**32):
        with pytest.raises(ValueError, match="uint32"):
            prng.fold_in(prng.PRNGKey(0), data)
