"""The port's optimizer pieces (repro_torch.optim) against the JAX
package's (repro.optim) on the same numpy trees, on the CPU.

AdamW's update is the JAX function op for op, so against the JAX function
called eagerly (each op rounded) it is bit for bit for fp32 parameters and
moments, and for bf16 parameters with fp32 and with bf16 moments.  (Under
jax.jit XLA contracts some of its products and sums into fused
multiply-adds, and moves the result by a few ulps: that is the JAX
package's own eager-vs-jit difference, not the port's.)  The schedule takes
its cosine from data.libm (glibc's cosf, XLA's on the CPU): bit for bit the
eager JAX schedule.  The global norm sums each
leaf's squares in fp32, in PyTorch's order, not XLA's: the norm is within 4
ulps of the JAX package's (2 measured), and so are the clipped leaves; a
tree under the clip norm comes back bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import cosine_warmup as jax_cosine_warmup
from repro_torch.convert import _tensor
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update, clip_by_global_norm,
                               cosine_warmup, global_norm)

DTYPE_PAIRS = [("float32", "float32"), ("bfloat16", "float32"), ("bfloat16", "bfloat16")]


def _to_torch(tree):
    return jax.tree.map(lambda a: _tensor(np.asarray(a), "cpu"), tree)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


def _ulps(got, want, dtype) -> float:
    """Largest |got - want| in units of the last place of `dtype` at want."""
    got, want = _f32(got).astype(np.float64), _f32(want).astype(np.float64)
    mant = {"float32": 23, "bfloat16": 7}[dtype]
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - mant)
    return float((np.abs(got - want) / ulp).max())


def _scene(pdt, mdt, seed=0):
    rng = np.random.default_rng(seed)
    params = {"a": jnp.asarray(rng.standard_normal((64, 33)), pdt),
              "b": {"c": jnp.asarray(rng.standard_normal((1000,)), pdt),
                    "d": jnp.asarray(rng.standard_normal((3, 5, 7)), pdt)}}
    grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape) * 1e-2, p.dtype),
                         params)
    state = {"mu": jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape) * 1e-2,
                                                      mdt), params),
             "nu": jax.tree.map(lambda p: jnp.asarray(rng.random(p.shape) * 1e-4, mdt), params),
             "count": jnp.asarray(0, jnp.int32)}
    return params, grads, state


@pytest.mark.parametrize("pdt,mdt", DTYPE_PAIRS)
@pytest.mark.parametrize("count", [0, 3, 100])
def test_adamw_update_matches_jax(pdt, mdt, count):
    params, grads, state = _scene(pdt, mdt, seed=count)
    state["count"] = jnp.asarray(count, jnp.int32)
    lr = jnp.float32(1e-3)
    want = jax_adamw_update(grads, state, params, JaxAdamWConfig(moment_dtype=mdt), lr)
    got = adamw_update(_to_torch(grads), _to_torch(state), _to_torch(params),
                       AdamWConfig(moment_dtype=mdt), torch.tensor(1e-3, dtype=torch.float32))
    assert got[1]["count"].dtype == torch.int32 and int(got[1]["count"]) == count + 1
    pairs = [(got[0], want[0], pdt), (got[1]["mu"], want[1]["mu"], mdt),
             (got[1]["nu"], want[1]["nu"], mdt)]
    for tree, ref, dt in pairs:
        for g, w in zip(jax.tree.leaves(tree), jax.tree.leaves(ref)):
            assert str(g.dtype).removeprefix("torch.") == dt
            assert np.array_equal(_f32(g), _f32(w))


@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
def test_adamw_init_matches_jax(mdt):
    params, _, _ = _scene("bfloat16", mdt)
    want = jax_adamw_init(params, JaxAdamWConfig(moment_dtype=mdt))
    got = adamw_init(_to_torch(params), AdamWConfig(moment_dtype=mdt))
    assert got["count"].dtype == torch.int32 and int(got["count"]) == 0
    for g, w in zip(jax.tree.leaves(got["mu"]) + jax.tree.leaves(got["nu"]),
                    jax.tree.leaves(want["mu"]) + jax.tree.leaves(want["nu"])):
        assert tuple(g.shape) == w.shape and str(g.dtype).removeprefix("torch.") == mdt
        assert float(g.float().abs().max()) == 0.0


@pytest.mark.parametrize("pdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [1e-3, 0.3, 1e3])
def test_clip_by_global_norm_matches_jax(pdt, max_norm):
    _, grads, _ = _scene(pdt, "float32", seed=7)
    want, wnorm = jax_clip(grads, max_norm)
    got, gnorm = clip_by_global_norm(_to_torch(grads), max_norm)
    assert gnorm.dtype == torch.float32
    assert _ulps(gnorm, wnorm, "float32") <= 4
    assert float(global_norm(_to_torch(grads))) == float(gnorm)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert str(g.dtype).removeprefix("torch.") == pdt
        if max_norm >= float(wnorm):           # no clip: the leaves as they were
            assert np.array_equal(_f32(g), _f32(w))
        else:
            assert _ulps(g, w, pdt) <= (4 if pdt == "float32" else 1)


@pytest.mark.parametrize("warmup,total", [(5, 20), (1, 3), (20, 100), (0, 10)])
def test_cosine_warmup_matches_jax(warmup, total):
    """Every step from 0 past the end: the eager JAX schedule's bits; a
    Python int step gives the same."""
    for s in range(total + 5):
        want = jax_cosine_warmup(jnp.int32(s), peak_lr=1e-3, warmup_steps=warmup,
                                 total_steps=total)
        got = cosine_warmup(torch.tensor(s, dtype=torch.int32), peak_lr=1e-3,
                            warmup_steps=warmup, total_steps=total)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == float(want), s
        assert float(cosine_warmup(s, peak_lr=1e-3, warmup_steps=warmup,
                                   total_steps=total)) == float(got)
