"""The training backward kernels' algorithms, on the CPU (B9ᵇ, B11ᵇ).

Both kernels run only on the card (tests/test_torch_cuda.py holds them to
their plain versions there).  Here, on numpy inputs made from a seed:

  * B11ᵇ: `wkv_bwd_chunked_ref`, the reverse pass's chunked algorithm
    spelled out in PyTorch (chunks of 16 from the last, dL/dS carried
    across them, per-row recursions whose decay factors are products of w
    and never quotients), against jax.vjp of the JAX package's plain WKV
    recurrence (repro/kernels/wkv/ref.py wkv_ref) and against the closed
    form `wkv_bwd_ref`, at 1e-5 normwise (max |got - want| <= 1e-5 max
    |want|, the closed form's own tolerance against jax.vjp): weak,
    moderate and strong decay, w exactly 0 in places, ragged tails, dh 32
    and 64; and its launch shape and scratch as pure functions.
  * B9ᵇ: the tensor-core backward's rounding points, emulated: P and dS
    enter their products as bf16 hi + lo halves, everything else fp32, the
    gradients rounded to bf16.  At the bf16 dh 64 / 128 shapes the card
    tests use (and smollm's heads at S = 1024) each gradient's normwise
    distance to the fp32 gradient stays within twice the plain bf16
    version's own, the card tests' bound.  Rounding P to bf16 alone, as the
    forward does, breaks that bound on a one-row case: the reason for the
    lo halves.  And the backward's (dtype, head dim) route table.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv.ref import wkv_ref as jax_wkv_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.wkv import ops as wkv_ops
from repro_torch.kernels.wkv import ref as wkv_ref

TOL = 1e-5


def _normwise(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------------ B11ᵇ

WKV_CASES = [  # b, s, h, dh, decay shift (w = exp(-exp(z + shift))), zero every nth w
    (2, 24, 3, 32, -1.0, 0),        # moderate, a ragged second chunk
    (1, 48, 2, 32, 1.0, 0),         # strong, whole chunks
    (2, 17, 2, 64, -6.0, 0),        # weak (w near 1), one token past a chunk
    (1, 37, 2, 64, 1.0, 5),         # strong, w exactly 0 every 5th token and 3rd row
    (1, 33, 1, 64, -1.0, 2),        # moderate, w exactly 0 every 2nd token
    (1, 1, 2, 32, -1.0, 0),         # one token
    (2, 16, 2, 64, 3.0, 3),         # very strong (w underflows to 0 in places), zeros
]


def _wkv_inputs(b, s, h, dh, shift, zero_every):
    rng = np.random.default_rng(1000 * s + 10 * h + dh)
    r, k, v, z, g = (rng.standard_normal((b, s, h, dh)).astype(np.float32) for _ in range(5))
    w = np.exp(-np.exp(z + shift)).astype(np.float32)
    if zero_every:
        w[:, ::zero_every, :, ::3] = 0.0
    u = (0.1 * rng.standard_normal((h, dh))).astype(np.float32)
    return r, k, v, w, u, g


@pytest.mark.parametrize("b,s,h,dh,shift,zero_every", WKV_CASES)
def test_wkv_bwd_chunked_ref_matches_jax_and_closed_form(b, s, h, dh, shift, zero_every):
    r, k, v, w, u, g = _wkv_inputs(b, s, h, dh, shift, zero_every)
    _, vjp = jax.vjp(jax_wkv_ref, r, k, v, w, u)
    want = vjp(jnp.asarray(g))
    tensors = [torch.from_numpy(x) for x in (r, k, v, w, u, g)]
    got = wkv_ref.wkv_bwd_chunked_ref(*tensors, c=wkv_ops.BWD_CHUNK, rows=wkv_ops.BWD_ROWS)
    closed = wkv_ref.wkv_bwd_ref(*tensors)
    for name, x, y, c in zip(("dr", "dk", "dv", "dw", "du"), got, want, closed):
        assert bool(torch.isfinite(x).all()), name
        assert _normwise(x, y) <= TOL, (name, _normwise(x, y))
        assert _normwise(x, c) <= TOL, (name, _normwise(x, c))
    if zero_every:   # dw is defined where w = 0 and not all zero there
        dw = got[3].numpy()
        assert np.abs(dw[w == 0.0]).max() > 0


def test_wkv_bwd_chunked_ref_row_blocks_sum_in_order():
    """dv is the sum over blocks of BWD_ROWS key rows: one block of all dh
    rows gives the same function (another order), within 1e-6."""
    tensors = [torch.from_numpy(x) for x in _wkv_inputs(1, 40, 2, 64, -1.0, 0)]
    split = wkv_ref.wkv_bwd_chunked_ref(*tensors, rows=32)
    whole = wkv_ref.wkv_bwd_chunked_ref(*tensors, rows=64)
    for name, x, y in zip(("dr", "dk", "dv", "dw", "du"), split, whole):
        assert _normwise(x, y) <= 1e-6, name
        if name != "dv":
            assert torch.equal(x, y), name


def test_wkv_bwd_geometry_hand_worked():
    """rwkv6's training shape: two blocks a head of 192 threads, 64 chunks,
    103,168 bytes of shared memory (two blocks an SM), the saved states half
    the former every-8-token scratch."""
    geo = wkv_ops.wkv_bwd_geometry(4, 1024, 32, 64)
    assert geo == {"grid": (64, 4), "threads": 192, "chunks": 64, "splits": 2,
                   "smem_bytes": 103168, "states": (4, 32, 2, 64, 32, 64),
                   "dv_part": (2, 4, 1024, 32, 64), "du_part": (4, 32, 64)}
    tile, vp = 16 * 40, 64 + 8
    assert wkv_ops.wkv_bwd_smem_bytes(64) == 4 * (
        3 * 3 * tile + 2 * (2 * 16 * vp + 32 * vp) + 2 * (2 * tile + 2 * 16 * 20 + 32)
        + 2 * 8 * 40 + 32 + 2 * 32 * vp + 2 * 16 * 36 + 16 * 20 + 5 * 32)
    assert all(2 * (wkv_ops.wkv_bwd_smem_bytes(dh) + 1024) <= 233472
               for dh in wkv_ops.HEAD_DIMS)
    states = 4 * int(np.prod(geo["states"]))
    assert states == 4 * 32 * 64 * 64 * 64 * 4 == 4 * 32 * (1024 // 8) * 64 * 64 * 4 // 2
    assert wkv_ops.wkv_bwd_geometry(2, 17, 3, 32)["grid"] == (3, 2)
    assert wkv_ops.wkv_bwd_geometry(1, 17, 1, 32)["chunks"] == 2
    with pytest.raises(ValueError, match="head dim 48"):
        wkv_ops.wkv_bwd_geometry(1, 16, 1, 48)


# ------------------------------------------------------------------- B9ᵇ

# the bf16 shapes at dh 64 and 128 of tests/test_torch_cuda.py's B9_BWD_CASES
# and its added cases, then smollm's heads at S = 1024 (one batch)
B9_TC_CASES = [
    (2, 150, 150, 15, 5, 64, True, 0),
    (2, 40, 93, 4, 2, 64, False, 0),
    (1, 96, 96, 8, 1, 128, True, 32),
    (1, 200, 200, 2, 2, 128, True, 0),
    (1, 1, 5, 4, 4, 64, False, 0),
    (1, 300, 300, 4, 1, 128, True, 130),
    (1, 1024, 1024, 15, 5, 64, True, 0),
]


def _bf16_halves(x: torch.Tensor, halves: int) -> torch.Tensor:
    """x as the kernel feeds it to a product: hi = bf16(x), plus lo =
    bf16(x - hi) when halves == 2."""
    hi = x.bfloat16().float()
    return hi if halves == 1 else hi + (x - hi).bfloat16().float()


def _emulate_tc_bwd(q, k, v, o, do, lse, causal, window, halves):
    """The tensor-core backward's arithmetic in fp32 with its rounding
    points: P and dS rounded to `halves` bf16 halves before dV = P^T dO,
    dK = scale dS^T Q and dQ = scale dS K; the gradients rounded to bf16."""
    b, sq, hq, dh = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = dh ** -0.5
    qg = q.reshape(b, sq, hkv, g, dh).float()
    dog = do.reshape(b, sq, hkv, g, dh).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    mask = fa_ref._mask(sq, skv, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse.reshape(b, hkv, g, sq)[..., None]), 0.0)
    delta = (dog * o.reshape(b, sq, hkv, g, dh).float()).sum(-1).permute(0, 2, 3, 1)
    ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float()) - delta[..., None])
    pr, dsr = _bf16_halves(p, halves), _bf16_halves(ds, halves)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", pr, dog)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", dsr, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", dsr, qg) * scale
    return (dq.reshape(b, sq, hq, dh).bfloat16(), dk.bfloat16(), dv.bfloat16())


def _b9_inputs(case, seed):
    b, sq, skv, hq, hkv, dh, causal, window = case
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((b, sq, hq, dh)).astype(np.float32))
             .bfloat16() for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, skv, hkv, dh)).astype(np.float32))
            .bfloat16() for _ in range(2))
    out, lse = fa_ref.attention_lse_ref(q, k, v, causal=causal, window=window)
    return q, k, v, out, do, lse


def _ratios(case, seed, halves):
    """Each gradient's normwise distance to the fp32 gradient over the plain
    bf16 version's own."""
    causal, window = case[6], case[7]
    q, k, v, out, do, lse = _b9_inputs(case, seed)
    plain = fa_ref.attention_bwd_ref(q, k, v, out, do, lse, causal=causal, window=window)
    want32 = fa_ref.attention_bwd_ref(q.float(), k.float(), v.float(), out.float(), do.float(),
                                      lse, causal=causal, window=window)
    got = _emulate_tc_bwd(q, k, v, out, do, lse, causal, window, halves)
    return [_normwise(a.float(), w) / _normwise(p.float(), w)
            for a, p, w in zip(got, plain, want32)]


@pytest.mark.parametrize("case", B9_TC_CASES)
def test_tc_backward_rounding_meets_bound(case):
    for seed in (0, 1):
        ratios = _ratios(case, seed, halves=2)
        assert max(ratios) <= 2.0, (seed, ratios)


def test_rounding_p_alone_breaks_bound_on_a_short_row():
    """One query row against five keys: dV_j = P_j dO is a single product,
    so P's bf16 rounding and the output's add up past twice the output's
    alone; with the lo half the distance is the plain version's."""
    case = (1, 1, 5, 4, 4, 64, False, 0)
    assert max(_ratios(case, 0, halves=1)) > 2.0
    assert max(_ratios(case, 0, halves=2)) <= 1.01


def test_backward_route_table():
    """bf16 at dh 64 and 128 takes the tensor-core backward, fp32 and bf16
    at dh 80 the FMA one; the table covers the forward's pairs and nothing
    else, and a pair outside it raises."""
    assert set(fa_ops.BWD_ROUTES) == set(fa_ops.ROUTES)
    assert {key for key, r in fa_ops.BWD_ROUTES.items() if r == "tc"} == {
        (torch.bfloat16, 64), (torch.bfloat16, 128)}
    assert fa_ops.bwd_route(torch.float32, 128) == "fma"
    assert fa_ops.bwd_route(torch.bfloat16, 80) == "fma"
    for dtype, dh in ((torch.bfloat16, 96), (torch.float16, 64)):
        with pytest.raises(ValueError, match="flash_attention_bwd: head dim"):
            fa_ops.bwd_route(dtype, dh)


def test_cpu_backward_counts_no_launch():
    """On CPU tensors the backward is the plain closed form: no counter moves."""
    from repro_torch.kernels import _build

    q, k, v, out, do, lse = _b9_inputs((1, 20, 20, 2, 1, 64, True, 0), 3)
    _build.reset_launches()
    got = fa_ops.flash_attention_bwd(q, k, v, out, do, lse)
    assert all(n == 0 for n in _build.LAUNCHES.values())
    for a, p in zip(got, fa_ref.attention_bwd_ref(q, k, v, out, do, lse)):
        assert torch.equal(a, p)
