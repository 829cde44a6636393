"""repro_torch.models.moe against the JAX package's MoE FFN, on the CPU in
fp32.

The JAX package's `moe_init` parameters cross as numpy arrays (the same
numbers on both sides) and the activations come from a seeded numpy draw.
Outputs are held at 1e-4 normwise (max |torch - jax| <= 1e-4 * max |jax|),
aux at 1e-5 relative: the same fp32 function summed in other orders.  The
cases take both of `moe_apply`'s paths:

  * the capacity path in one group and in several (moe_group_size 8 at
    s 16), with tokens dropped past capacity (capacity_factor 0.5: the
    test checks that some are), and with exact router ties (two experts
    with the same router column, and a zero router: every expert tied),
    where jax.lax.top_k takes the lower index first;
  * the dense path, for decode and for s <= top_k (aux 0).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import moe

TOL = 1e-4


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1e-30)
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def _cfgs(arch, **over):
    return (dataclasses.replace(jax_get_config(arch, smoke=True), **over),
            dataclasses.replace(get_config(arch, smoke=True), **over))


def _params(jcfg, seed=0, ties=None):
    """JAX moe_init parameters as numpy; `ties` = "pair" gives experts 1 and
    2 the same router column, "all" a zero router."""
    p = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(seed), jcfg))
    p = {k: np.array(v) for k, v in p.items()}
    if ties == "pair":
        p["router"][:, 2] = p["router"][:, 1]
    elif ties == "all":
        p["router"][:] = 0.0
    return p


def _run(jcfg, cfg, p, x, decode=False):
    jout, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg,
                                decode=decode)
    out, aux = moe.moe_apply({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), cfg, decode=decode)
    return (out.numpy(), float(aux)), (np.asarray(jout), float(jaux))


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


# (arch, overrides, s, ties)
CAPACITY = [
    ("phi3.5-moe-42b-a6.6b", {}, 16, None),
    ("phi3.5-moe-42b-a6.6b", {"moe_group_size": 8}, 16, None),
    ("phi3.5-moe-42b-a6.6b", {"moe_group_size": 8, "capacity_factor": 0.5}, 16, None),
    ("phi3.5-moe-42b-a6.6b", {"capacity_factor": 0.5}, 16, "pair"),
    ("phi3.5-moe-42b-a6.6b", {"moe_group_size": 8}, 16, "all"),
    ("mixtral-8x22b", {"capacity_factor": 0.5}, 24, None),
]


@pytest.mark.parametrize("arch,over,s,ties", CAPACITY)
def test_capacity_path_matches_jax(arch, over, s, ties):
    jcfg, cfg = _cfgs(arch, **over)
    p = _params(jcfg, ties=ties)
    x = _x(2, s, cfg.d_model)
    (out, aux), (jout, jaux) = _run(jcfg, cfg, p, x)
    _close(out, jout, TOL, "out")
    assert aux > 0 and abs(aux - jaux) <= 1e-5 * abs(jaux), (aux, jaux)


@pytest.mark.parametrize("group", [8, 16])
def test_capacity_path_drops_tokens_as_jax(group):
    """At capacity_factor 0.5 some first choices overflow their expert's
    slots: those tokens get no expert output from that choice, on both
    sides (a token dropped by both of its choices comes out exactly 0)."""
    jcfg, cfg = _cfgs("phi3.5-moe-42b-a6.6b", moe_group_size=group, capacity_factor=0.5)
    p = _params(jcfg, seed=2)
    x = _x(2, 16, cfg.d_model, seed=3)
    (out, _), (jout, _) = _run(jcfg, cfg, p, x)
    _close(out, jout, TOL, "out")
    cap = int(-(-group * cfg.top_k * cfg.capacity_factor // cfg.n_experts))
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(p["router"]), dim=-1)
    first = moe.top_k(probs, cfg.top_k)[1][..., 0].reshape(2, -1, group)
    per_expert = torch.nn.functional.one_hot(first, cfg.n_experts).sum(dim=2)
    assert int(per_expert.max()) > cap          # first choices alone overflow
    zero_rows = np.abs(jout).max(axis=-1) == 0.0
    np.testing.assert_array_equal(np.abs(out).max(axis=-1) == 0.0, zero_rows)


@pytest.mark.parametrize("ties", [None, "pair", "all"])
@pytest.mark.parametrize("s,decode", [(1, True), (2, False), (3, True)])
def test_dense_path_matches_jax(s, decode, ties):
    jcfg, cfg = _cfgs("phi3.5-moe-42b-a6.6b")
    p = _params(jcfg, seed=4, ties=ties)
    x = _x(3, s, cfg.d_model, seed=5)
    (out, aux), (jout, jaux) = _run(jcfg, cfg, p, x, decode=decode)
    _close(out, jout, TOL, "out")
    assert aux == 0.0 and jaux == 0.0


@pytest.mark.parametrize("shape", [(5, 4), (2, 7, 16), (3, 2, 8)])
def test_top_k_ties_go_to_the_lower_index(shape):
    rng = np.random.default_rng(6)
    probs = rng.integers(0, 3, shape).astype(np.float32)     # many exact ties
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    v, i = moe.top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_moe_init_shapes_dtypes_and_scale():
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = _cfgs("mixtral-8x22b", param_dtype=dtype)
        want = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
        got = moe.moe_init(torch.Generator().manual_seed(0), cfg)
        assert set(got) == set(want)
        for k, w in want.items():
            assert tuple(got[k].shape) == w.shape, k
            assert str(got[k].dtype).removeprefix("torch.") == jnp.dtype(w.dtype).name, k
            # the JAX package's dense_init: scale 1/sqrt(shape[0]), the
            # expert count for the (E, ., .) weights
            std, jstd = float(got[k].float().std()), float(jnp.std(w.astype(jnp.float32)))
            assert abs(std / jstd - 1.0) < 0.05, (k, std, jstd)
