"""repro_torch.models.mamba against the JAX package's Mamba-1 mixer, on the
CPU in fp32.

The JAX package's `mamba_init` parameters cross as numpy arrays and the
activations come from a seeded numpy draw; outputs and states are held at
1e-4 normwise (max |torch - jax| <= 1e-4 * max |jax|): the same fp32
function, the scan in another tree order.  Cases: the full-sequence pass
with one scan (mamba_chunk 0, Jamba's setting) and chunked (mamba_chunk 8
at S 16 and 24), the final state that prefill hands to decode (the JAX
package's transformer._mamba_final_state), and decode steps from a cache,
chained.  The log-depth `scan` is held to the sequential recurrence in
float64 at lengths that are and are not powers of two, and its autograd
form to the in-place one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import mamba as jmamba
from repro.models import transformer as jtransformer
from repro_torch.configs import get_config
from repro_torch.convert import _tensor
from repro_torch.models import mamba

TOL = 1e-4


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1e-30)
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def _setup(seed=0, **over):
    jcfg = dataclasses.replace(jax_get_config("jamba-v0.1-52b", smoke=True), **over)
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b", smoke=True), **over)
    jp = jmamba.mamba_init(jax.random.PRNGKey(seed), jcfg)
    p = {k: _tensor(np.asarray(v), "cpu") for k, v in jp.items()}
    return jcfg, cfg, jp, p


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


@pytest.mark.parametrize("chunk,s", [(0, 16), (0, 13), (8, 16), (8, 24), (8, 12)])
def test_mamba_apply_matches_jax(chunk, s):
    jcfg, cfg, jp, p = _setup(mamba_chunk=chunk)
    x = _x(2, s, cfg.d_model)
    want = jmamba.mamba_apply(jp, jnp.asarray(x), jcfg)
    got = mamba.mamba_apply(p, torch.from_numpy(x), cfg)
    _close(got, want, TOL, "out")
    got2, state = mamba.mamba_apply(p, torch.from_numpy(x), cfg, final_state=True)
    assert torch.equal(got2, got)
    jstate = jtransformer._mamba_final_state(jp, jnp.asarray(x), jcfg)
    for name in ("h", "conv"):
        assert state[name].dtype == torch.float32
        _close(state[name], jstate[name], TOL, f"final state {name}")


def test_mamba_decode_chain_matches_jax():
    """Prefill 12 tokens, then 5 decode steps, each from the last step's
    cache, on both sides."""
    jcfg, cfg, jp, p = _setup(seed=3)
    x = _x(2, 17, cfg.d_model, seed=4)
    _, cache = mamba.mamba_apply(p, torch.from_numpy(x[:, :12]), cfg, final_state=True)
    jcache = jtransformer._mamba_final_state(jp, jnp.asarray(x[:, :12]), jcfg)
    for t in range(12, 17):
        jout, jcache = jmamba.mamba_decode(jp, jnp.asarray(x[:, t:t + 1]), jcache, jcfg)
        out, cache = mamba.mamba_decode(p, torch.from_numpy(x[:, t:t + 1]), cache, cfg)
        _close(out, jout, TOL, f"step {t} out")
        for name in ("h", "conv"):
            assert cache[name].dtype == torch.float32
            _close(cache[name], jcache[name], TOL, f"step {t} cache {name}")
    # the decode chain continues the full-sequence pass
    full = mamba.mamba_apply(p, torch.from_numpy(x), cfg)
    _close(out[:, 0], full[:, -1], TOL, "last decode vs full pass")


def test_mamba_decode_from_random_cache_matches_jax():
    jcfg, cfg, jp, p = _setup(seed=5)
    rng = np.random.default_rng(6)
    shapes = mamba.mamba_cache_shape(cfg, 3)
    assert shapes == jmamba.mamba_cache_shape(jcfg, 3)
    cache = {k: rng.standard_normal(v).astype(np.float32) for k, v in shapes.items()}
    x = _x(3, 1, cfg.d_model, seed=7)
    jout, jnew = jmamba.mamba_decode(jp, jnp.asarray(x), jax.tree.map(jnp.asarray, cache), jcfg)
    out, new = mamba.mamba_decode(p, torch.from_numpy(x),
                                  {k: torch.from_numpy(v) for k, v in cache.items()}, cfg)
    _close(out, jout, TOL, "out")
    for name in ("h", "conv"):
        _close(new[name], jnew[name], TOL, name)


def test_bf16_decode_conv_runs_in_fp32_as_jax():
    """A bf16 layer's decode step: the fp32 conv cache promotes the conv and
    the x_proj product to fp32 (the prefill's run in bf16), y is cast to
    bf16 before the gate; the output is bf16 and the new cache fp32."""
    over = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg, cfg, jp, p = _setup(seed=8, **over)
    x = _x(2, 9, cfg.d_model, seed=9).astype(jnp.bfloat16)
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    _, cache = mamba.mamba_apply(p, xt[:, :8], cfg, final_state=True)
    jcache = jtransformer._mamba_final_state(jp, jnp.asarray(x[:, :8]), jcfg)
    jout, jnew = jmamba.mamba_decode(jp, jnp.asarray(x[:, 8:]), jcache, jcfg)
    out, new = mamba.mamba_decode(p, xt[:, 8:], cache, cfg)
    assert out.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
    assert new["h"].dtype == new["conv"].dtype == torch.float32
    assert jnew["h"].dtype == jnew["conv"].dtype == jnp.float32
    # the conv inputs are bf16 values in an fp32 cache: equal on both sides
    np.testing.assert_array_equal(new["conv"].numpy(), np.asarray(jnew["conv"]))
    _close(out.float(), np.asarray(jout, np.float32), 2e-2, "bf16 out")


def _sequential(a, b):
    h = np.zeros_like(b[:, 0])
    out = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return np.stack(out, axis=1)


@pytest.mark.parametrize("s", [1, 2, 5, 8, 13, 64])
def test_scan_is_the_recurrence(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (2, s, 3, 4))
    b = rng.standard_normal((2, s, 3, 4))
    prods, h = mamba.scan(torch.from_numpy(a.copy()), torch.from_numpy(b.copy()))
    np.testing.assert_allclose(h.numpy(), _sequential(a, b), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(prods.numpy(), np.cumprod(a, axis=1), rtol=1e-12)
    # under autograd: new tensors, the same numbers, and gradients
    at = torch.from_numpy(a).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    prods_g, h_g = mamba.scan(at, bt)
    np.testing.assert_array_equal(h_g.detach().numpy(), h.numpy())
    np.testing.assert_array_equal(at.detach().numpy(), a)
    h_g.sum().backward()
    # d(sum h)/d b_t = 1 + a_{t+1} + a_{t+1} a_{t+2} + ...
    gb = np.zeros_like(b)
    for t in range(s):
        g, acc = 1.0, np.ones_like(b[:, 0])
        for u in range(t + 1, s):
            acc = acc * a[:, u]
            g = g + acc
        gb[:, t] = g
    np.testing.assert_allclose(bt.grad.numpy(), gb, rtol=1e-10)


def test_mamba_init_matches_jax_distributions():
    for dtype in ("float32", "bfloat16"):
        over = dict(param_dtype=dtype, compute_dtype=dtype)
        jcfg = dataclasses.replace(jax_get_config("jamba-v0.1-52b"), d_model=512, **over)
        cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), d_model=512, **over)
        want = jmamba.mamba_init(jax.random.PRNGKey(0), jcfg)
        got = mamba.mamba_init(torch.Generator().manual_seed(0), cfg)
        assert set(got) == set(want)
        for k, w in want.items():
            assert tuple(got[k].shape) == w.shape, k
            assert str(got[k].dtype).removeprefix("torch.") == jnp.dtype(w.dtype).name, k
        for k in ("d_skip", "conv_b"):
            np.testing.assert_array_equal(got[k].float().numpy(),
                                          np.asarray(want[k], np.float32))
        # log(1..n): torch's float32 log and XLA's differ by an ulp at some n
        np.testing.assert_allclose(got["a_log"].numpy(), np.asarray(want["a_log"]),
                                   rtol=2.5e-7, atol=0)
        dt = torch.nn.functional.softplus(got["dt_bias"])
        assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 1e-1 * (1 + 1e-5)
        for k in ("in_proj", "conv_w", "x_proj", "dt_proj", "out_proj"):
            std, jstd = float(got[k].float().std()), float(jnp.std(want[k].astype(jnp.float32)))
            assert abs(std / jstd - 1.0) < 0.1, (k, std, jstd)
    assert get_config("jamba-v0.1-52b").dt_rank == 256
