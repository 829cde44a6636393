"""repro_torch LM kernels: the plain PyTorch versions against the JAX package.

The three LM-stack kernels of the port (flash attention, flash decode, the
RWKV-6 WKV recurrence) each have a plain PyTorch version that the ops
wrappers run for CPU tensors.  Here those are held, on the same numpy inputs
(made from a seed), in fp32, against

  * the JAX `ref.py` oracles, at 1e-5 normwise
    (max |torch - jax| <= 1e-5 * max |jax|): the same function in another
    summation order, both sides fp32;
  * the JAX Pallas kernels in interpret mode, also at 1e-5 normwise: online
    softmax against eager softmax for the attention kernels, and for WKV the
    chunked form, which divides by the within-chunk cumulative decay and is
    within 1.3e-6 normwise of the exact recurrence at these inputs (the JAX
    package's own test holds it to its ref at 2e-3 elementwise);
  * the port's chunked twin against the JAX model's chunked form, and the
    final WKV state against the JAX prefill's replay of the recurrence.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
holds them against these plain versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.flash_attention.ops import flash_attention as jflash_attention
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref
from repro.kernels.flash_decode.ops import flash_decode as jflash_decode
from repro.kernels.flash_decode.ref import decode_ref as jdecode_ref
from repro.kernels.wkv.ops import wkv_chunked as jwkv_chunked
from repro.kernels.wkv.ref import wkv_ref as jwkv_ref
from repro.models import layers as jlayers
from repro.models import rwkv as jrwkv
from repro.models import transformer as jtransformer
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import _tensor
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.kernels.flash_decode.ref import decode_ref
from repro_torch.kernels.wkv.ops import wkv_chunked
from repro_torch.kernels.wkv.ref import wkv_chunked_ref, wkv_ref
from repro_torch.models import layers
from repro_torch.models import rwkv

TOL = 1e-5


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1e-30)
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _wkv_inputs(seed, b, s, h, dh, strong=False):
    r, k, v, wl = _normal(seed, *[(b, s, h, dh)] * 4)
    # w in (0.01, 0.99), or strong decay: log w = -exp(z + 1), z ~ N(0, 1)
    w = (np.exp(-np.exp(wl + 1.0)) if strong
         else 1 / (1 + np.exp(-wl)) * 0.98 + 0.01).astype(np.float32)
    u = (_normal(seed + 1, (h, dh))[0] * 0.1).astype(np.float32)
    return r, k, v, w, u


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ------------------------------------------------------- B9 flash attention

# b, sq, skv, hq, hkv, dh, causal, window
_ATTN_CASES = [
    (2, 64, 64, 4, 4, 32, True, 0),       # G = 1
    (1, 150, 150, 6, 2, 64, True, 0),     # G = 3, ragged Sq (Pallas pads)
    (2, 100, 100, 8, 2, 32, True, 24),    # G = 4, sliding window, ragged
    (1, 77, 77, 3, 1, 80, True, 16),      # the smollm smoke heads, window
    (1, 128, 128, 15, 5, 64, True, 0),    # the smollm full-width heads
    (1, 64, 64, 6, 2, 32, False, 0),      # non-causal
]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,dh,causal,window", _ATTN_CASES)
def test_flash_attention_plain_matches_jax(b, sq, skv, hq, hkv, dh, causal, window):
    q, k, v = _normal(sq + hq, (b, sq, hq, dh), (b, skv, hkv, dh), (b, skv, hkv, dh))
    got = flash_attention(*_t(q, k, v), causal=causal, window=window)
    assert got.dtype == torch.float32
    _close(got, jattention_ref(*_j(q, k, v), causal=causal, window=window), TOL, "ref")
    pallas = jflash_attention(*_j(q, k, v), causal=causal, window=window,
                              use_pallas=True, interpret=True, bq=64, bk=64)
    _close(got, pallas, TOL, "pallas")


@pytest.mark.parametrize("sq,skv,q_offset,window", [
    (16, 80, 64, 0),        # a query block at the end of a longer sequence
    (24, 96, 40, 32),       # a block in the middle, sliding window
    (1, 50, 49, 0),         # one decode token
])
def test_flash_attention_q_offset_matches_layers(sq, skv, q_offset, window):
    """A query block at q_offset (chunked attention's later blocks, decode's
    one token) through the port's layers.attention_scores against the JAX
    model's, which carries the same offset.  (The kernels' ops, like the
    JAX ops, start the queries at position 0.)"""
    q, k, v = _normal(7 + sq, (2, sq, 6, 32), (2, skv, 2, 32), (2, skv, 2, 32))
    got = layers.attention_scores(*_t(q, k, v), causal=True, window=window,
                                  q_offset=q_offset)
    want = jlayers.attention_scores(*_j(q, k, v), causal=True, window=window,
                                    q_offset=q_offset)
    _close(got, want, TOL, "q_offset")


def test_flash_attention_ragged_noncausal_is_exact():
    """Skv not a multiple of any block and no causal mask: the JAX wrapper
    refuses this call (its padding would leak into the softmax); the port's
    kernel masks the edge, and its plain version is the eager oracle."""
    q, k, v = _normal(3, (1, 40, 4, 32), (1, 93, 2, 32), (1, 93, 2, 32))
    got = flash_attention(*_t(q, k, v), causal=False)
    _close(got, jattention_ref(*_j(q, k, v), causal=False), TOL)
    with pytest.raises(ValueError):
        jflash_attention(*_j(q, k, v), causal=False, use_pallas=True, interpret=True,
                         bq=32, bk=32)


# ---------------------------------------------------------- B10 flash decode

# b, s, hq, hkv, dh, idx, window
_DECODE_CASES = [
    (2, 96, 4, 4, 32, 0, 0),          # idx at 0: one position
    (2, 200, 6, 2, 64, 117, 0),       # G = 3, idx mid-cache
    (1, 160, 8, 2, 32, 159, 0),       # G = 4, idx at the end
    (2, 300, 3, 1, 80, 250, 64),      # the smollm smoke heads, window
    (1, 1088, 15, 5, 64, 1087, 0),    # the smollm serving cache
    (1, 160, 32, 2, 128, 150, 0),     # G = 16: llama3-405b's head ratio
    (2, 130, 16, 1, 64, 129, 40),     # G = 16 at dh 64, window
]


@pytest.mark.parametrize("b,s,hq,hkv,dh,idx,window", _DECODE_CASES)
def test_flash_decode_plain_matches_jax(b, s, hq, hkv, dh, idx, window):
    q, k, v = _normal(s + idx, (b, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh))
    got = flash_decode(*_t(q, k, v), idx, window=window)
    assert got.dtype == torch.float32
    _close(got, jdecode_ref(*_j(q, k, v), idx, window=window), TOL, "ref")
    pallas = jflash_decode(*_j(q, k, v), idx, window=window, use_pallas=True,
                           interpret=True, bk=128)
    _close(got, pallas, TOL, "pallas")


# ----------------------------------------------------------------- B11 WKV

# b, s, h, dh, chunk
_WKV_CASES = [
    (2, 64, 4, 32, 32),
    (1, 100, 2, 64, 32),      # Pallas pads the tail
    (2, 48, 3, 16, 16),
]


@pytest.mark.parametrize("b,s,h,dh,chunk", _WKV_CASES)
def test_wkv_plain_matches_jax(b, s, h, dh, chunk):
    r, k, v, w, u = _wkv_inputs(s + dh, b, s, h, dh)
    got, state = wkv_chunked(*_t(r, k, v, w, u))
    assert got.dtype == torch.float32 and state.shape == (b, h, dh, dh)
    _close(got, jwkv_ref(*_j(r, k, v, w, u)), TOL, "ref")
    pallas = jwkv_chunked(*_j(r, k, v, w, u), chunk=chunk, use_pallas=True,
                          interpret=True)
    _close(got, pallas, TOL, "pallas")


def test_wkv_chunked_twin_matches_jax():
    """The chunked plain form (the JAX model's route for rwkv_chunk > 0)
    against the JAX model's _wkv_chunked, and against the exact recurrence
    that the port runs for every config, out and final state."""
    r, k, v, w, u = _wkv_inputs(11, 2, 64, 2, 16)
    got, state = wkv_chunked_ref(*_t(r, k, v, w, u), 16)
    _close(got, jrwkv._wkv_chunked(*_j(r, k, v, w, u), 16), TOL, "chunked")
    exact, exact_state = wkv_ref(*_t(r, k, v, w, u))
    _close(got, exact, TOL, "chunked vs exact")
    _close(state, exact_state, TOL, "chunked state vs exact")
    # the op is the exact recurrence
    _close(wkv_chunked(*_t(r, k, v, w, u))[0], exact, 0.0, "op")


def test_wkv_strong_decay_recurrence_stays_finite():
    """Strong decay (log w down to -e^4 per token): the exact recurrence,
    which the card's kernel runs, stays finite and matches the JAX oracle;
    the chunked form (JAX's and its twin alike) overflows fp32 in
    exp(-log P), the hazard the kernel's design avoids."""
    r, k, v, w, u = _wkv_inputs(12, 2, 64, 2, 16, strong=True)
    got, state = wkv_ref(*_t(r, k, v, w, u))
    assert torch.isfinite(got).all() and torch.isfinite(state).all()
    _close(got, jwkv_ref(*_j(r, k, v, w, u)), TOL, "exact")
    assert not np.isfinite(np.asarray(jrwkv._wkv_chunked(*_j(r, k, v, w, u), 16))).all()
    assert not torch.isfinite(wkv_chunked_ref(*_t(r, k, v, w, u), 16)[0]).all()


@pytest.mark.parametrize("arch", ["rwkv6-1.6b"])
def test_wkv_final_state_matches_jax_replay(arch):
    """The state the time-mix returns (the kernel writes it; the plain
    version computes the same) against the JAX prefill's replay of the
    recurrence, transformer._rwkv_final_state."""
    jcfg, cfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    pp = jrwkv.rwkv_time_init(jax.random.PRNGKey(3), jcfg)
    tp = {name: _tensor(np.asarray(a), "cpu") for name, a in pp.items()}
    (h,) = _normal(5, (2, 24, cfg.d_model))
    out, state = rwkv.rwkv_time_apply(tp, torch.from_numpy(h), cfg)
    _close(out, jrwkv.rwkv_time_apply(pp, jnp.asarray(h), jcfg), TOL, "out")
    want = jtransformer._rwkv_final_state(pp, jnp.asarray(h), jcfg)
    _close(state, want["wkv"], TOL, "state")


# --------------------------------------------------------------- wrappers


def test_wrappers_run_plain_versions_on_cpu():
    """A CPU tensor takes the plain version: the same values, no launch."""
    _build.reset_launches()
    q, k, v = _normal(1, (1, 20, 4, 32), (1, 20, 2, 32), (1, 20, 2, 32))
    assert torch.equal(flash_attention(*_t(q, k, v), window=8),
                       attention_ref(*_t(q, k, v), window=8))
    assert torch.equal(flash_decode(*_t(q[:, 0], k, v), 11, window=5),
                       decode_ref(*_t(q[:, 0], k, v), 11, window=5))
    r, kk, vv, w, u = _wkv_inputs(2, 1, 20, 2, 16)
    assert all(map(torch.equal, wkv_chunked(*_t(r, kk, vv, w, u)), wkv_ref(*_t(r, kk, vv, w, u))))
    assert _build.LAUNCHES["flash_attention"] == 0
    assert _build.LAUNCHES["flash_decode"] == 0
    assert _build.LAUNCHES["wkv"] == 0


@pytest.mark.parametrize("call", ["attention", "decode", "wkv"])
def test_wrappers_refuse_bad_shapes_and_devices(call):
    meta = dict(device="meta")
    if call == "attention":
        with pytest.raises(ValueError):    # Hq not a multiple of Hkv
            flash_attention(torch.zeros(1, 8, 5, 32), torch.zeros(1, 8, 2, 32),
                            torch.zeros(1, 8, 2, 32))
        with pytest.raises(ValueError):    # no kernel for this device
            flash_attention(torch.zeros(1, 8, 4, 32, **meta), torch.zeros(1, 8, 2, 32, **meta),
                            torch.zeros(1, 8, 2, 32, **meta))
    elif call == "decode":
        with pytest.raises(ValueError):    # q (B, Hq, dh) expected
            flash_decode(torch.zeros(1, 1, 4, 32), torch.zeros(1, 8, 2, 32),
                         torch.zeros(1, 8, 2, 32), 3)
        with pytest.raises(ValueError):
            flash_decode(torch.zeros(1, 4, 32, **meta), torch.zeros(1, 8, 2, 32, **meta),
                         torch.zeros(1, 8, 2, 32, **meta), 3)
    else:
        with pytest.raises(ValueError):    # u of the wrong shape
            wkv_chunked(*[torch.zeros(1, 8, 2, 16)] * 4, torch.zeros(2, 8))
        with pytest.raises(ValueError):
            wkv_chunked(*[torch.zeros(1, 8, 2, 16, **meta)] * 4, torch.zeros(2, 16, **meta))


# --------------------------------------------------------- model layers


def test_layers_attention_routes_like_jax_on_cpu():
    """layers.attention_scores and chunked_attention (the model's attention,
    plain on the CPU) against their JAX twins, prefill and decode forms."""
    q, k, v = _normal(9, (2, 32, 6, 32), (2, 32, 2, 32), (2, 32, 2, 32))
    for window in (0, 8):
        _close(layers.attention_scores(*_t(q, k, v), causal=True, window=window),
               jlayers.attention_scores(*_j(q, k, v), causal=True, window=window),
               TOL, "prefill")
        _close(layers.chunked_attention(*_t(q, k, v), causal=True, window=window, q_block=8),
               jlayers.chunked_attention(*_j(q, k, v), causal=True, window=window, q_block=8),
               TOL, "chunked")
        _close(layers.attention_scores(*_t(q[:, :1], k, v), causal=True, window=window,
                                       q_offset=20),
               jlayers.attention_scores(*_j(q[:, :1], k, v), causal=True, window=window,
                                        q_offset=20), TOL, "decode")


# ------------------------------------------------- host-side kernel logic


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if get_config(a).n_heads])
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_flash_attention_route_covers_configs(arch, smoke):
    """Every (dtype, head dim) a config's attention runs in has a kernel in
    the routing table; the full configs' bf16 heads (64 or 128) take the
    tensor-core kernel."""
    cfg = get_config(arch, smoke=smoke)
    dh, dtype = cfg.resolved_head_dim, cfg.cdtype()
    kernel = fa_ops.route(dtype, dh)
    assert kernel in ("tc", "fma")
    if dtype == torch.bfloat16 and dh in (64, 128):
        assert kernel == "tc"
    if dtype == torch.float32:
        assert kernel == "fma"          # fp32 parity: no tensor cores


@pytest.mark.parametrize("dtype,dh", [(torch.bfloat16, 96), (torch.float32, 32),
                                      (torch.float16, 64), (torch.bfloat16, 256)])
def test_flash_attention_route_refuses_unknown(dtype, dh):
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.route(dtype, dh)


# The kernel's tiles (its library reports them; tests/test_torch_cuda.py
# pins the values): 64 positions at dh 64 bf16, 32 at dh 64 fp32 and at dh
# 80/128 bf16, 16 at dh 80/128 fp32.
@pytest.mark.parametrize("n,pairs,tile,n_sm", [
    (1, 1, 64, 132),             # one position
    (64, 40, 64, 132),           # exactly one tile
    (65, 40, 64, 132),           # one tile and one position
    (1088, 40, 64, 132),         # the smollm serving cache
    (5000, 5, 64, 132),          # B = 1: many chunks
    (32768, 640, 64, 132),       # decode_32k: the longest chunks
    (300, 2, 32, 132),           # the smoke heads (dh 80 bf16)
    (999, 3, 16, 132),           # fp32 dh 128, G = 8 shape
    (1000, 1, 64, 7),            # a small card
    (262144, 1, 32, 132),        # a very long cache (dh 128 bf16)
    (1088, 40, 32, 132),         # the serving cache in fp32
    (31, 1, 32, 132),            # less than one tile
    (4097, 8, 16, 132),          # fp32 dh 80/128, a ragged end
    (32768, 128, 32, 132),       # decode_32k at dh 128
    (1, 640, 16, 132),           # one position, many pairs
    (500, 3, 64, 1),             # a one-SM card
])
def test_decode_geometry_covers_positions(n, pairs, tile, n_sm):
    chunk, nsplit = fd_ops.decode_geometry(n, pairs, tile, n_sm)
    tiles = -(-n // tile)
    assert chunk % tile == 0 and 0 < chunk <= fd_ops.MAX_CHUNK_TILES * tile
    assert (nsplit - 1) * chunk < n <= nsplit * chunk      # covered, no chunk empty
    assert nsplit <= tiles
    # about BLOCKS_PER_SM blocks per SM where the cache has the tiles for
    # them: whole tiles per chunk round the count down, at most to half
    assert 2 * nsplit * pairs >= min(fd_ops.BLOCKS_PER_SM * n_sm, pairs * tiles)


@pytest.mark.parametrize("n,pairs,g,dh,tile", [(1088, 40, 3, 64, 64), (5000, 5, 3, 64, 64),
                                               (2501, 4, 4, 128, 32), (10, 1, 8, 80, 32)])
def test_decode_workspace_holds_partials(n, pairs, g, dh, tile):
    """The workspace a call gets holds its nsplit partials and zeroed
    arrival counters, and grows when a larger call comes."""
    fd_ops._WORKSPACES.clear()
    small_arr, small_part = fd_ops._workspace(torch.device("cpu"), 0, 1, 10)
    _, nsplit = fd_ops.decode_geometry(n, pairs, tile)
    need = fd_ops.partial_floats(pairs, nsplit, g, dh)
    assert need == (pairs * nsplit * g * (dh + 2) if nsplit > 1 else 0)
    arrivals, part = fd_ops._workspace(torch.device("cpu"), 0, pairs, need)
    assert arrivals.dtype == torch.int32 and arrivals.numel() >= pairs
    assert not arrivals.any() and part.numel() >= max(need, 1)
    assert fd_ops._workspace(torch.device("cpu"), 0, pairs, need)[1] is part   # reused
    assert fd_ops._workspace(torch.device("cpu"), 1, pairs, need)[1] is not part  # per stream
    fd_ops._WORKSPACES.clear()
