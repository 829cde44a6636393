"""Gradients of the port's LM training path against jax.grad, on the CPU.

The plain versions of the two backward kernels are closed forms written
out in PyTorch (repro_torch.kernels.flash_attention.ref.attention_bwd_ref,
repro_torch.kernels.wkv.ref.wkv_bwd_ref); the JAX package has no backward
kernel, so they are held to jax.vjp of its plain oracles
(repro/kernels/flash_attention/ref.py attention_ref, repro/kernels/wkv/ref.py
wkv_ref) on the same numpy inputs, in fp32 (both oracles cast to float32
inside, so no float64 comparison is possible), at 1e-5 of each gradient's
largest magnitude.  The autograd.Functions of the two kernels
(flash_attention_train, wkv_train) give the same gradients on CPU tensors.

`Model.loss` and every parameter's gradient for the smollm-360m and
rwkv6-1.6b smoke configs are held to jax.value_and_grad(model.loss) from the
same parameters (convert.lm_params_from_numpy) and batch: the loss at 1e-6
relative, each leaf at 1e-5 of its largest magnitude for smollm.  For rwkv6
the tolerance is the JAX package's own one-ulp spread of that gradient (its
gradients with every fp32 parameter moved one ulp up), measured in the
test: the WKV recurrence through two layers amplifies rounding, and that
spread (about 1e-4 of a leaf's largest magnitude) is above 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.lm import lm_batches as jax_lm_batches
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.wkv.ref import wkv_ref as jax_wkv_ref
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data.lm import lm_batches
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.wkv import ops as wkv_ops
from repro_torch.kernels.wkv import ref as wkv_ref
from repro_torch.models import build_model
from repro_torch.optim.clip import tree_leaves, tree_map

TOL = 1e-5


def _normwise(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("b,sq,skv,hq,hkv,dh,causal,window", [
    (2, 37, 37, 3, 3, 16, True, 0),       # G = 1
    (2, 37, 37, 6, 2, 16, True, 0),       # G = 3
    (1, 50, 50, 6, 2, 32, True, 7),       # G = 3, window
    (1, 29, 29, 4, 4, 80, True, 5),       # G = 1, window, the smoke head dim
    (1, 20, 33, 6, 2, 16, False, 0),      # non-causal, Skv > Sq
])
def test_attention_backward_matches_jax_grad(b, sq, skv, hq, hkv, dh, causal, window):
    rng = np.random.default_rng(sq * hq + dh)
    q, do = (rng.standard_normal((b, sq, hq, dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, skv, hkv, dh)).astype(np.float32) for _ in range(2))
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_attention_ref(q_, k_, v_, causal=causal,
                                                          window=window), q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = fa_ref.attention_lse_ref(tq, tk, tv, causal=causal, window=window)
    assert torch.equal(out, fa_ref.attention_ref(tq, tk, tv, causal=causal, window=window))
    got = fa_ops.flash_attention_bwd(tq, tk, tv, out, tdo, lse, causal=causal, window=window)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    auto = torch.autograd.grad(fa_ops.flash_attention_train(*leaves, causal=causal,
                                                            window=window), leaves, tdo)
    for name, g, a, w in zip(("dq", "dk", "dv"), got, auto, want):
        assert _normwise(g, w) <= TOL, name
        assert torch.equal(g, a), name


@pytest.mark.parametrize("b,s,h,dh,shift", [(2, 24, 3, 16, -1.0), (1, 40, 2, 32, 1.0),
                                            (2, 17, 2, 64, -6.0)])
def test_wkv_backward_matches_jax_grad(b, s, h, dh, shift):
    """Moderate (-1), strong (+1) and weak (-6: w near 1) decay."""
    rng = np.random.default_rng(s * h + dh)
    r, k, v, z, g = (rng.standard_normal((b, s, h, dh)).astype(np.float32) for _ in range(5))
    w = np.exp(-np.exp(z + shift)).astype(np.float32)
    u = (0.1 * rng.standard_normal((h, dh))).astype(np.float32)
    _, vjp = jax.vjp(jax_wkv_ref, r, k, v, w, u)
    want = vjp(jnp.asarray(g))
    tensors = list(map(torch.from_numpy, (r, k, v, w, u)))
    got = wkv_ops.wkv_bwd(*tensors, torch.from_numpy(g))
    leaves = [t.clone().requires_grad_(True) for t in tensors]
    out, state = wkv_ops.wkv_train(*leaves)
    assert not state.requires_grad
    assert torch.equal(state, wkv_ref.wkv_ref(*tensors)[1])
    auto = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, x, a, y in zip(("dr", "dk", "dv", "dw", "du"), got, auto, want):
        assert _normwise(x, y) <= TOL, name
        assert torch.equal(x, a), name
        assert float(x.abs().max()) > 0, name
    assert all(torch.equal(x, y) for x, y in zip(got, wkv_ref.wkv_bwd_ref(
        *tensors, torch.from_numpy(g))))


def _jax_one_ulp_spread(f, jparams, jbatch, grads):
    """Each leaf's normwise change of the JAX gradient when every fp32
    parameter moves one ulp up."""
    up = jax.tree.map(lambda a: jnp.asarray(np.nextafter(np.asarray(a), np.float32(np.inf))),
                      jparams)
    (_, _), moved = f(up, jbatch)
    return [_normwise(a, b) for a, b in zip(jax.tree.leaves(moved), jax.tree.leaves(grads))]


@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-1.6b"])
def test_model_loss_and_gradients_match_jax(arch):
    jmodel = jax_build_model(jax_get_config(arch, smoke=True))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    jbatch = next(jax_lm_batches(jmodel, seq=32, batch=2))
    batch = next(lm_batches(model, seq=32, batch=2, device="cpu"))
    assert np.array_equal(np.asarray(jbatch["tokens"]), batch["tokens"].numpy())
    f = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))
    (jloss, jmet), jgrads = f(jparams, jbatch)
    params = tree_map(lambda t: t.requires_grad_(True),
                      lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams)))
    loss, met = model.loss(params, batch)
    grads = torch.autograd.grad(loss, list(tree_leaves(params)))
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-6 * abs(float(jloss))
    assert float(met["aux"]) == 0.0 and float(jmet["aux"]) == 0.0
    assert abs(float(met["ce"].detach()) - float(jmet["ce"])) <= 1e-6 * abs(float(jmet["ce"]))
    want = list(tree_leaves(lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jgrads))))
    # the port's leaves in the JAX tree's order (blocks stacked over layers)
    per_leaf = [_normwise(g, w) for g, w in zip(grads, want)]
    assert len(per_leaf) == len(want) and all(float(g.abs().max()) > 0 for g in grads)
    if arch.startswith("smollm"):
        assert max(per_leaf) <= TOL, max(per_leaf)
    else:
        spread = max(_jax_one_ulp_spread(f, jparams, jbatch, jgrads))
        assert max(per_leaf) <= max(TOL, spread), (max(per_leaf), spread)
