"""repro_torch WKV (B11): the CUDA kernel's overflow-safe chunked algorithm,
spelled out in PyTorch (kernels.wkv.ref.wkv_safe_chunked_ref), against the
JAX package, and the kernel's launch shape.

The kernel runs only on the card (tests/test_torch_cuda.py holds it to the
plain versions there); here its algorithm is held, on the same numpy inputs
made from a seed, in fp32, to

  * the JAX oracle repro.kernels.wkv.ref.wkv_ref (the sequential recurrence)
    and the final state of the same recurrence in JAX, at 1e-5 normwise
    (max |torch - jax| <= 1e-5 * max |jax|): the same function in another
    summation order, both sides fp32;
  * the JAX Pallas kernel wkv_chunked_pallas in interpret mode, also at 1e-5
    (at moderate decay, where its division by the cumulative decay is safe);
  * at strong decay (log w down to about -e^4 a token) the JAX recurrence at
    1e-5 with every value finite, where the JAX package's chunked forms
    overflow fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv.ops import wkv_chunked as jwkv_chunked
from repro.kernels.wkv.ref import wkv_ref as jwkv_ref
from repro.models import rwkv as jrwkv
from repro_torch.kernels.wkv.ops import CHUNK, HEAD_DIMS, wkv_geometry, wkv_smem_bytes
from repro_torch.kernels.wkv.ref import wkv_ref, wkv_safe_chunked_ref

TOL = 1e-5


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), f"{what}: non-finite values"
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1e-30)
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def _wkv_inputs(seed, b, s, h, dh, strong=False):
    """As tests/test_torch_lm_kernels.py: w in (0.01, 0.99), or strong decay
    log w = -exp(z + 1), z ~ N(0, 1); u ~ 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k, v, wl = (rng.standard_normal((b, s, h, dh)).astype(np.float32) for _ in range(4))
    w = (np.exp(-np.exp(wl + 1.0)) if strong
         else 1 / (1 + np.exp(-wl)) * 0.98 + 0.01).astype(np.float32)
    u = (np.random.default_rng(seed + 1).standard_normal((h, dh)) * 0.1).astype(np.float32)
    return r, k, v, w, u


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _jax_final_state(r, k, v, w):
    """S_T of the JAX recurrence S_t = diag(w_t) S_{t-1} + k_t v_t^T."""
    b, _, h, dh = r.shape

    def step(state, t):
        _, kt, vt, wt = t
        return wt[..., :, None] * state + kt[..., :, None] * vt[..., None, :], None

    xs = jax.tree.map(lambda a: jnp.swapaxes(a, 0, 1), (r, k, v, w))
    state, _ = jax.lax.scan(step, jnp.zeros((b, h, dh, dh), jnp.float32), xs)
    return state


# b, s, h, dh: S a multiple of CHUNK, ragged, and smaller than one chunk,
# at the head dims 16, 32 and 64
_CASES = [
    (2, 64, 3, 16),
    (1, 48, 2, 64),
    (1, 37, 2, 32),
    (2, 21, 2, 64),
    (2, 5, 2, 64),
    (1, 1, 3, 32),
]


@pytest.mark.parametrize("b,s,h,dh", _CASES)
def test_safe_chunked_matches_jax(b, s, h, dh):
    r, k, v, w, u = _wkv_inputs(3 * s + dh, b, s, h, dh)
    out, state = wkv_safe_chunked_ref(*_t(r, k, v, w, u), CHUNK)
    assert out.dtype == torch.float32 and state.shape == (b, h, dh, dh)
    _close(out, jwkv_ref(*_j(r, k, v, w, u)), TOL, "out vs JAX recurrence")
    _close(state, _jax_final_state(*_j(r, k, v, w)), TOL, "state vs JAX recurrence")
    pallas = jwkv_chunked(*_j(r, k, v, w, u), chunk=CHUNK, use_pallas=True, interpret=True)
    _close(out, pallas, TOL, "out vs Pallas interpret")


@pytest.mark.parametrize("b,s,h,dh", [(2, 64, 2, 16), (1, 37, 2, 32), (1, 80, 1, 64)])
def test_safe_chunked_strong_decay_stays_finite(b, s, h, dh):
    """log w down to about -e^4 a token: the kernel's algorithm stays finite
    and equal to the JAX recurrence, out and state; the JAX package's chunked
    forms divide by the chunk's cumulative decay and overflow fp32."""
    r, k, v, w, u = _wkv_inputs(12 + s, b, s, h, dh, strong=True)
    out, state = wkv_safe_chunked_ref(*_t(r, k, v, w, u), CHUNK)
    assert torch.isfinite(out).all() and torch.isfinite(state).all()
    _close(out, jwkv_ref(*_j(r, k, v, w, u)), TOL, "out vs JAX recurrence")
    _close(state, _jax_final_state(*_j(r, k, v, w)), TOL, "state vs JAX recurrence")
    s64 = -(-s // 64) * 64                                   # the model's form needs S % c == 0
    padded = [np.concatenate([a, np.full((b, s64 - s, h, dh), f, np.float32)], axis=1)
              for a, f in ((r, 0.0), (k, 0.0), (v, 0.0), (w, 1.0))]
    assert not np.isfinite(np.asarray(jrwkv._wkv_chunked(*_j(*padded, u), 64))).all()
    pallas = jwkv_chunked(*_j(r, k, v, w, u), chunk=64, use_pallas=True, interpret=True)
    assert not np.isfinite(np.asarray(pallas)).all()


@pytest.mark.parametrize("c", [2, 4, 8, 16, 32])
def test_safe_chunked_any_chunk_is_the_recurrence(c):
    """The chunk length changes only the summation order."""
    r, k, v, w, u = _wkv_inputs(7, 2, 45, 2, 16, strong=c % 4 == 0)
    out, state = wkv_safe_chunked_ref(*_t(r, k, v, w, u), c)
    want, want_state = wkv_ref(*_t(r, k, v, w, u))
    _close(out, want, TOL, f"out, c={c}")
    _close(state, want_state, TOL, f"state, c={c}")


def test_wkv_geometry_hand_worked():
    """The rwkv6 serving shape: a block per (head, batch) of 4 dh threads
    over 64 chunks; its shared memory (3 raw stages of 4 x 16 x 72 floats,
    2 operand stages of 2 x 16 x 72 + 2 x 16 x 20 + 64 floats, the cross factors
    2 x 8 x 72, u 64) leaves room for two blocks on an H100 SM (228 KB, 1 KB
    reserved a block)."""
    assert wkv_geometry(8, 1024, 32, 64) == {"grid": (32, 8), "threads": 256,
                                             "chunks": 64, "smem_bytes": 84224}
    assert wkv_smem_bytes(64) == 4 * (3 * 4 * 1152 + 2 * (2 * 1152 + 2 * 16 * 20 + 64)
                                      + 2 * 8 * 72 + 64)
    assert wkv_smem_bytes(32) == 49024
    assert all(2 * (wkv_smem_bytes(dh) + 1024) <= 233472 for dh in HEAD_DIMS)
    assert [wkv_geometry(1, s, 1, 32)["chunks"] for s in (1, 15, 16, 17, 1023)] == [1, 1, 1, 2, 64]
    with pytest.raises(ValueError, match="head dim"):
        wkv_geometry(1, 16, 1, 48)
