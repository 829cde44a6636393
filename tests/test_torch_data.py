"""repro_torch.data against repro.data, from the seed on (no numpy hand-off).

  * every source x {float32, float64 (jax.enable_x64)} x 3 seeds against
    `repro.data.sources.make_dataset`: the raw uniform covariates of the
    Friedman and cosine sources bit for bit before standardisation, and
    after it (the train split's mean and standard deviation are summed in
    the order of XLA's CPU code, `friedman.xla_sum`, which equals jax's
    reduction bit for bit); the datasets within 2e-6 (float32) and 1e-12
    (float64) — the outcomes' sin / atan / cos, correlated_linear's
    Cholesky factor and product, and the f64 normals' log round
    differently in the two libraries;
  * all five partitions against `repro.data.partition` over a grid of
    (n_attrs, n_agents, options): the same groups, or the same error; the
    column masks equal; DataSpec rejects unequal groups as the JAX
    package's does;
  * `make_trial_batch` draws every trial in one pass, and trial b has the
    bits of `make_dataset(seed=seeds[b])`; `DataSpec.build` has them too;
  * `data.friedman.make_dataset` against the JAX package's.
"""
import jax
import numpy as np
import pytest
import torch

from repro.api.specs import DataSpec as JDataSpec
from repro.api.specs import SpecError as JSpecError
from repro.data import friedman as jfriedman
from repro.data import partition as jpart
from repro.data import sources as jsrc
from repro_torch import api as tapi
from repro_torch import prng
from repro_torch.data import friedman as tfriedman
from repro_torch.data import partition as tpart
from repro_torch.data import sources as tsrc

SOURCES = ("friedman1", "friedman2", "friedman3", "correlated_linear", "cosine")
UNIFORM_SOURCES = ("friedman1", "friedman2", "friedman3", "cosine")
DATA_TOL = {torch.float32: 2e-6, torch.float64: 1e-12}
OPTIONS = {"correlated_linear": (("rho", 0.8), ("snr", 5.0)),
           "cosine": (("freq", 2.0),)}


def _dtype(x64):
    return torch.float64 if x64 else torch.float32


@pytest.mark.parametrize("seed", (0, 7, 2**31 - 1))
@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("source", SOURCES)
def test_dataset_matches_jax(source, x64, seed):
    opts = OPTIONS.get(source, ())
    n_attrs = 7 if source in ("correlated_linear", "cosine") else None
    with jax.enable_x64(x64):
        want = [np.asarray(a) for a in jsrc.make_dataset(
            source, 300, 120, seed, noise=0.1, n_attrs=n_attrs, options=opts)]
    got = tsrc.make_dataset(source, 300, 120, seed, noise=0.1, n_attrs=n_attrs,
                            options=opts, dtype=_dtype(x64))
    for name, g, w in zip(("x", "y", "x_test", "y_test"), got, want):
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        err = np.max(np.abs(g - w))
        assert err <= DATA_TOL[_dtype(x64)], (name, err)


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("source", UNIFORM_SOURCES)
def test_raw_uniform_covariates_bit_for_bit(source, x64):
    for seed in (0, 7, 2**31 - 1):
        for split in (0, 1):
            with jax.enable_x64(x64):
                jkey = jax.random.split(jax.random.PRNGKey(seed))[split]
                want = np.asarray(jsrc.SOURCES[source].fn(jkey, 257, 5, 0.0)[0])
            key = prng.split(prng.PRNGKey(seed))[split]
            got = tsrc.SOURCES[source].fn(key, 257, 5, 0.0, _dtype(x64))[0]
            np.testing.assert_array_equal(got.numpy(), want)


PARTITION_GRID = [
    ("one_per_agent", 5, 5, ()), ("one_per_agent", 5, 4, ()),
    ("round_robin", 10, 5, ()), ("round_robin", 7, 3, ()),
    ("round_robin", 3, 5, ()), ("round_robin", 4, 0, ()),
    ("blocks", 10, 5, ()), ("blocks", 7, 3, ()), ("blocks", 12, 5, ()),
    ("blocks", 3, 4, ()), ("blocks", 6, 1, ()),
    ("overlapping", 6, 3, (("overlap", 1),)),
    ("overlapping", 10, 5, (("overlap", 2),)),
    ("overlapping", 7, 3, (("overlap", 0),)),
    ("overlapping", 6, 3, (("overlap", 5),)),
    ("overlapping", 6, 3, (("overlap", -1),)),
    ("random", 10, 5, ()), ("random", 10, 5, (("seed", 3),)),
    ("random", 9, 4, (("seed", 11),)), ("random", 4, 6, ()),
]


@pytest.mark.parametrize("scheme,n_attrs,n_agents,options", PARTITION_GRID,
                         ids=lambda v: str(v))
def test_partitions_match_jax(scheme, n_attrs, n_agents, options):
    try:
        want = jpart.make_groups(scheme, n_attrs, n_agents, options)
    except ValueError as e:
        with pytest.raises(type(e)) as got:
            tpart.make_groups(scheme, n_attrs, n_agents, options)
        assert str(got.value) == str(e)
        return
    got = tpart.make_groups(scheme, n_attrs, n_agents, options)
    assert got == want
    np.testing.assert_array_equal(tpart.column_mask(got, n_attrs),
                                  jpart.column_mask(want, n_attrs))
    assert tpart.PARTITIONS[scheme].options == jpart.PARTITIONS[scheme].options


@pytest.mark.parametrize("partition,n_attrs,n_agents", [
    ("blocks", 7, 3), ("round_robin", 7, 3), ("random", 10, 4),
    ("blocks", 10, 5), ("overlapping", 6, 3)])
def test_unequal_groups_rejected_as_jax_does(partition, n_attrs, n_agents):
    kw = dict(source="correlated_linear", n_attrs=n_attrs, n_agents=n_agents,
              partition=partition)
    try:
        JDataSpec(**kw).validate()
    except JSpecError:
        with pytest.raises(tapi.SpecError, match="unequal group sizes"):
            tapi.DataSpec(**kw).validate()
        return
    tapi.DataSpec(**kw).validate()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("source", SOURCES)
def test_trial_batch_equals_single_draws(source, dtype):
    seeds = [4, 0, 9]
    if source in ("correlated_linear", "cosine"):
        n_attrs, groups = 6, [[0, 1], [2, 3], [4, 5]]
    else:
        n_attrs, groups = None, [[j] for j in range(5)]
    xcols, y, xcols_t, y_t = tsrc.make_trial_batch(
        source, 200, 64, seeds, groups, noise=0.05, n_attrs=n_attrs,
        dtype=dtype)
    assert xcols.shape == (3, len(groups), 200, len(groups[0]))
    assert xcols.dtype == y.dtype == dtype
    for b, seed in enumerate(seeds):
        xtr, ytr, xte, yte = tsrc.make_dataset(source, 200, 64, seed, noise=0.05,
                                               n_attrs=n_attrs, dtype=dtype)
        assert torch.equal(xcols[b], torch.stack([xtr[:, g] for g in groups]))
        assert torch.equal(xcols_t[b], torch.stack([xte[:, g] for g in groups]))
        assert torch.equal(y[b], ytr) and torch.equal(y_t[b], yte)


def test_dataspec_builds_its_seed_in_the_default_dtype():
    spec = tapi.DataSpec(source="cosine", n_train=100, n_test=40, seed=5,
                         n_attrs=4, n_agents=2, partition="blocks")
    data = spec.build("cpu")
    assert data.xcols.shape == (2, 100, 2) and data.groups == [[0, 1], [2, 3]]
    assert data.xcols.dtype == torch.get_default_dtype()
    batch = tsrc.make_trial_batch("cosine", 100, 40, [5], data.groups,
                                  n_attrs=4)
    for got, want in zip(data[:4], batch):
        assert torch.equal(got, want[0])


@pytest.mark.parametrize("which", [1, 2, 3])
def test_friedman_make_dataset_matches_jax(which):
    want = [np.asarray(a) for a in jfriedman.make_dataset(which, 300, 100, seed=4,
                                                          noise=0.1)]
    got = tfriedman.make_dataset(which, 300, 100, seed=4, noise=0.1)
    for g, w in zip(got, want):
        assert np.max(np.abs(g.numpy() - w)) <= DATA_TOL[torch.float32]


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 300, 2000, 40000])
def test_xla_sum_equals_jax_reduction(n, x64):
    """jnp.sum over a major axis, compiled by XLA for the CPU, and
    friedman.xla_sum: the same bits (the mean and std of standardise)."""
    dt = np.float64 if x64 else np.float32
    x = np.random.default_rng(n).standard_normal((n, 7)).astype(dt)
    with jax.enable_x64(x64):
        want = np.asarray(jax.jit(lambda a: a.sum(axis=0))(x))
    got = tfriedman.xla_sum(torch.from_numpy(x), 0)
    np.testing.assert_array_equal(got.numpy(), want)
    batch = torch.from_numpy(np.stack([x, 2 * x]))
    assert torch.equal(tfriedman.xla_sum(batch, -2)[0], got)


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("source", UNIFORM_SOURCES)
def test_standardised_covariates_bit_for_bit(source, x64):
    """The Friedman and cosine covariates after standardisation, both
    splits: equal to the JAX package's bit for bit."""
    opts = OPTIONS.get(source, ())
    for seed, n in ((0, 300), (7, 2000)):
        with jax.enable_x64(x64):
            want = [np.asarray(a) for a in jsrc.make_dataset(
                source, n, 120, seed, noise=0.1, options=opts)]
        got = tsrc.make_dataset(source, n, 120, seed, noise=0.1, options=opts,
                                dtype=_dtype(x64))
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[2].numpy(), want[2])
