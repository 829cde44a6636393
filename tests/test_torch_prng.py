"""repro_torch.prng against jax.random (jax 0.9.0's defaults: threefry2x32,
jax_threefry_partitionable=True): bit for bit.

  * PRNGKey, split (num 2, 3, 5) and bits, as uint32 words, for seeds
    {0, 1, 7, 2**31 - 1} and several shapes;
  * permutation as integers for n in {2, 5, 20, 2000, 65537, 262144} (one
    sort round up to n = 1625, two above: the round count is pinned too);
  * a batch of keys (B, 2) gives each key's own result;
  * covariance.subsample_indices draws the JAX package's subsample.
"""
import jax
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
