"""repro_torch on the card: the CUDA kernels against their plain versions,
`api.fit` and `api.batch_fit` on the card against the same runs on the CPU,
and the LM serving path (the smoke configs of the dense, ssm, moe and hybrid
families) on the card against the CPU.

Every test here is marked `cuda` and skips without a CUDA device: the
kernels have no CPU mode.  The file imports neither jax nor repro, so it
also runs where only PyTorch is installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are normwise (max |kernel - plain| <= tol * max |plain|): 1e-5
for the Gram products, 1e-4 for the sweep kernels, whose closed-form
epilogue divides by SMW pivots.  The probe kernel evaluates that epilogue
(and ||cross||^2) in float64, so its plain version is evaluated in float64
on the same fp32 inputs: near a pole of the step schedule the fp32 plain
version is itself more than 1e-4 (normwise) from the float64 value on the
card (test_batched_kernels_match_plain_and_single[100-20000-3]).  The batched kernels
must give trial b exactly the single-trial kernel's bits (torch.equal).
The LM kernels (flash attention, flash decode, WKV) are held to 1e-5 in
fp32 and to 8e-3 in bf16 (about two bf16 roundings of the output: both
sides accumulate in fp32 and round once to bf16); the serving path's
logits on the card to the CPU's at 1e-4 (fp32, a few layers), and in
bf16 at head dim 64 (B9's tensor-core route) within twice the CPU's own
bf16-vs-fp32 gap.  The commit is held at 1e-4 with equal accept flags, on
its 4-byte load path, with Python-number and tensor operands, and right
after the other kernels that share its arrival counters; under Minimax
Protection's split it reads diag_keep = 0 and a device diag_add (one per
trial in the batch), held to the plain version at D = 5 and 100 and the
subsample widths m = 20 and 2622.  The threefry subsample drawn on the card
equals the CPU's, and Minimax Protection's fits (alpha = 20, delta = 0 and
0.01) on the card match the CPU's.  Data drawn on the card: uniforms,
64-bit words, fold_in and float32 normals equal the CPU's bit for bit;
float64 normals within 4 ulp of the CPU's (torch.log differs); a trial
batch drawn in one pass gives each trial its single draw's bits; the
batched dense engine's trials match their single-trial runs on the card;
a Result saved on the card loads back on it with the same predictions.
The transport layer: B6 and B8 with one agent per trial give slice b the
single launch's bits on agent i[b]; the lossy codecs' round trips on the
card equal the CPU's bit for bit; a budgeted star batch (greedy_eta) has
the CPU's per-trial ledgers.  The C library's float32 sin / cos / atan
(data.libm) and the fault trace's bit flips on the card equal the CPU's
bit for bit; a commit gated off by the fault trace leaves the state
bitwise; a faulted paper fit has the CPU's bytes and histories within
1e-4; an mlp fit on the card is within 1e-9 of the CPU's in float64.
Observability and the stream: every tap of a fused paper fit on the card
(use_kernel) equals the CPU's (int taps and accept flags equal, float taps
within 1e-4); the stream's chunks on the card equal the CPU's bit for bit;
replace_cols on the card matches the CPU, one arrival and a chunk (float64
1e-12, float32 1e-5); a short float64 stream on the card has the CPU's bytes
and records within 1e-8, in float32 on the kernels its accept flags and
bytes and records within 4x the CPU's spread between its two engines;
stream_fit under a caller's TF32 gives the bits it gives without; a stream
checkpoint saved on the card restores on the CPU with the same leaves.
LM training: B9's training forward gives the serving forward's bits and
the rows' log-sum-exp; the B9 and B11 backward kernels give the same bits
twice and hold to their plain closed forms on the same inputs (fp32 within
1e-4 normwise; bf16 within twice the plain bf16 version's own distance to
the fp32 gradient); the smoke configs' loss and every gradient on the card
(fp32) within 1e-4 of the CPU's, one train_step likewise; the moe, hybrid,
encdec and vlm smoke configs' first two train_steps likewise (B9's backward
also at whisper-medium's encoder and cross-attention shapes and at
qwen2-vl-7b's G = 7); init_state and launch.train run on the card by
default.  The shard_map backend: two ranks of a gloo group on cuda:0 each
launch B1 and B3, counted by their own launch counters.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import api, prng
from repro_torch.core import covariance as cov
from repro_torch.core import minimax
from repro_torch.kernels import _build
from repro_torch.kernels.gram import ops as gram_ops
from repro_torch.kernels.gram import ref as gram_ref
from repro_torch.kernels.sweep import ops as sweep_ops
from repro_torch.kernels.sweep import ref as sweep_ref
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.kernels.flash_decode.ref import decode_ref
from repro_torch.kernels.wkv.ops import CHUNK, HEAD_DIMS, wkv_chunked, wkv_smem_bytes
from repro_torch.kernels.wkv.ref import wkv_ref, wkv_safe_chunked_ref
from repro_torch.launch.serve import build_prompt
from repro_torch.models import build_model, layers
from repro_torch.serve import ServeEngine
from repro_torch.serve.engine import _pad_cache

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _scene(d, n, seed, device):
    """Residual rows, an SPD m_inv with s = m_inv 1, eta = sum s, a small
    row delta, a vector v and a K=16 step schedule."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((d, 2 * d))
    m_inv = m @ m.T / (2 * d) + np.eye(d)
    m_inv = 0.5 * (m_inv + m_inv.T)
    s = m_inv.sum(axis=1)
    out = dict(r=rng.standard_normal((d, n)), m_inv=m_inv, s=s, eta=s.sum(),
               delta=0.05 * rng.standard_normal(n), v=rng.standard_normal(n),
               steps=math.sqrt(n) * 0.5 ** np.arange(16))
    return {k: torch.tensor(np.asarray(a, np.float32), device=device)
            for k, a in out.items()}


def _f64(args):
    """The operands in float64, for the probe's plain version (see above)."""
    return tuple(a.double() if isinstance(a, torch.Tensor) else a for a in args)


def _close(got, want, tol, what):
    err = float((got.double() - want.double()).abs().max())
    scale = max(float(want.double().abs().max()), 1e-30)
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


# D picks the gram block's thread groups: 4 up to D=104, 3 at 105-120 (here
# 120), 2 at 121-128, 1 (two tiles, off-diagonal pairs) above
GRAM_CASES = [(1, 7), (5, 600), (64, 3000), (65, 3000), (100, 20000), (100, 20001),
              (120, 2002), (127, 999), (128, 4096), (129, 7), (300, 20001)]


def _unaligned_copy(x):
    """x's values in a contiguous tensor that starts 4 bytes into its
    storage, so the kernels take their 4-byte load path."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("d,n", GRAM_CASES)
def test_kernels_match_plain(card, d, n):
    """Each kernel against its plain version; gram, row_gram and the probe
    also give the same bits twice, on a copy that starts off 16-byte
    alignment (the 4-byte load path), and after a call of another geometry
    (row_gram's and the probe's arrival counters are left zero); gram is
    exactly symmetric."""
    sc = _scene(d, n, seed=d, device=card)
    i = d // 2
    before = dict(_build.LAUNCHES)
    got = gram_ops.gram(sc["r"])
    _close(got, gram_ref.gram_ref(sc["r"]), 1e-5, "gram")
    assert torch.equal(got, got.T)
    assert torch.equal(got, gram_ops.gram(sc["r"]))
    assert torch.equal(got, gram_ops.gram(_unaligned_copy(sc["r"])))
    rg = gram_ops.row_gram(sc["v"], sc["r"])
    _close(rg, gram_ref.row_gram_ref(sc["v"], sc["r"]), 1e-5, "row_gram")
    assert torch.equal(rg, gram_ops.row_gram(sc["v"], sc["r"]))
    assert torch.equal(rg, gram_ops.row_gram(_unaligned_copy(sc["v"]),
                                             _unaligned_copy(sc["r"])))
    other = _scene(d + 3, 2 * n + 5, seed=d + 1, device=card)   # another geometry
    _close(gram_ops.row_gram(other["v"], other["r"]),
           gram_ref.row_gram_ref(other["v"], other["r"]), 1e-5, "row_gram (other)")
    _close(gram_ops.gram(other["r"]), gram_ref.gram_ref(other["r"]), 1e-5, "gram (other)")
    assert torch.equal(rg, gram_ops.row_gram(sc["v"], sc["r"]))
    assert torch.equal(got, gram_ops.gram(sc["r"]))
    args = (sc["r"], sc["m_inv"], sc["s"], sc["eta"], i, sc["steps"])
    probe = sweep_ops.probe_sweep(*args)
    for g, w in zip(probe, sweep_ref.probe_sweep_ref(*_f64(args))):
        _close(g, w, 1e-4, "probe")
    assert all(map(torch.equal, probe, sweep_ops.probe_sweep(*args)))
    assert all(map(torch.equal, probe,
                   sweep_ops.probe_sweep(_unaligned_copy(sc["r"]), *args[1:])))
    oargs = (other["r"], other["m_inv"], other["s"], other["eta"], i, other["steps"])
    for g, w in zip(sweep_ops.probe_sweep(*oargs), sweep_ref.probe_sweep_ref(*_f64(oargs))):
        _close(g, w, 1e-4, "probe (other)")
    assert all(map(torch.equal, probe, sweep_ops.probe_sweep(*args)))
    for thr in (float("-inf"), float("inf")):
        cargs = (sc["r"], sc["m_inv"], sc["s"], sc["eta"], i, sc["delta"],
                 1.0, 0.0, thr, True)
        got, want = sweep_ops.commit_sweep(*cargs), sweep_ref.commit_sweep_ref(*cargs)
        assert bool(got[3]) == bool(want[3]) == (thr < 0)
        for k in (0, 1, 2, 4):
            _close(got[k], want[k], 1e-4, "commit")
        if thr > 0:    # a reject is a bitwise no-op
            assert torch.equal(got[0], sc["m_inv"]) and torch.equal(got[1], sc["s"])
    torch.cuda.synchronize()
    # one launch per call: gram 5 calls, row_gram 5, probe 5
    assert {k: _build.LAUNCHES[k] - before[k] for k in before} == {
        "gram": 5, "row_gram": 5, "probe_sweep": 5, "commit_sweep": 2,
        "gram_batched": 0, "row_gram_batched": 0, "probe_sweep_batched": 0,
        "commit_sweep_batched": 0, "probe_sweep_batched_per_trial": 0,
        "commit_sweep_batched_per_trial": 0, "flash_attention": 0,
        "flash_attention_tc": 0, "flash_decode": 0, "wkv": 0, "flash_attention_bwd": 0,
        "flash_attention_bwd_tc": 0, "wkv_bwd": 0}


COMMIT_CASES = [(100, 262144), (100, 20001), (129, 4096), (300, 20001), (5, 600)]


@pytest.mark.parametrize("d,n", COMMIT_CASES)
def test_commit_paths_match_plain(card, d, n):
    """The one-launch commit against its plain version (1e-4) on its paths:
    accept and reject, the same bits twice and on copies of r and delta 4
    bytes off alignment (the 4-byte load path; N % 4 != 0 takes it too),
    threshold / can_tx as Python numbers and as device tensors, accept a
    0-d torch.bool, a reject a bitwise no-op, m_inv' exactly symmetric; one
    launch a call."""
    sc = _scene(d, n, seed=7 * d, device=card)
    i = d // 2
    base = (sc["r"], sc["m_inv"], sc["s"], sc["eta"], i, sc["delta"], 1.0, 0.0)
    before = _build.LAUNCHES["commit_sweep"]
    for thr in (float("-inf"), float("inf")):
        got = sweep_ops.commit_sweep(*base, thr, True)
        want = sweep_ref.commit_sweep_ref(*base, thr, True)
        assert got[3].dtype == torch.bool and got[3].shape == ()
        assert bool(got[3]) == bool(want[3]) == (thr < 0)
        for k in (0, 1, 2, 4):
            _close(got[k], want[k], 1e-4, f"commit D={d} N={n} thr={thr}")
        for again in (sweep_ops.commit_sweep(*base, thr, True),
                      sweep_ops.commit_sweep(_unaligned_copy(sc["r"]), *base[1:5],
                                             _unaligned_copy(sc["delta"]), 1.0, 0.0,
                                             thr, True),
                      sweep_ops.commit_sweep(*base, torch.tensor(thr, device=card),
                                             torch.tensor(1.0, device=card))):
            assert all(map(torch.equal, got, again))
        if thr > 0:
            assert torch.equal(got[0], sc["m_inv"]) and torch.equal(got[1], sc["s"])
            assert not bool(got[2].any())
        else:
            assert torch.equal(got[0], got[0].T)
    gated = sweep_ops.commit_sweep(*base, float("-inf"), False)     # the transport gate
    assert not bool(gated[3]) and torch.equal(gated[0], sc["m_inv"])
    torch.cuda.synchronize()
    assert _build.LAUNCHES["commit_sweep"] == before + 9


def test_commit_after_probe_and_row_gram(card):
    """A commit right after a probe and a row_gram on the same stream, all
    sharing the arrival counters: each still matches its plain version and
    the commit gives the bits it gave before (the counters came back to
    zero), single and batched."""
    sc = _scene(100, 20001, seed=3, device=card)
    i = 40
    cargs = (sc["r"], sc["m_inv"], sc["s"], sc["eta"], i, sc["delta"], 1.0, 0.0,
             float("-inf"), True)
    first = sweep_ops.commit_sweep(*cargs)
    pargs = (sc["r"], sc["m_inv"], sc["s"], sc["eta"], i, sc["steps"])
    for g, w in zip(sweep_ops.probe_sweep(*pargs), sweep_ref.probe_sweep_ref(*_f64(pargs))):
        _close(g, w, 1e-4, "probe")
    _close(gram_ops.row_gram(sc["v"], sc["r"]), gram_ref.row_gram_ref(sc["v"], sc["r"]),
           1e-5, "row_gram")
    assert all(map(torch.equal, first, sweep_ops.commit_sweep(*cargs)))
    bt = _batch(129, 3001, 4, card)
    bargs = (bt["r"], bt["m_inv"], bt["s"], bt["eta"], 64, bt["delta"], 1.0, 0.0,
             torch.tensor([-math.inf, math.inf] * 2, device=card), True)
    batched = sweep_ops.commit_sweep(*bargs)
    sweep_ops.probe_sweep(bt["r"], bt["m_inv"], bt["s"], bt["eta"], 64, bt["steps"])
    gram_ops.row_gram(bt["v"], bt["r"])
    again = sweep_ops.commit_sweep(*bargs)
    assert all(map(torch.equal, batched, again))
    assert batched[3].dtype == torch.bool and batched[3].tolist() == [True, False] * 2
    want = sweep_ref.commit_sweep_batched_ref(*bargs)
    for k in (0, 1, 2, 4):
        _close(batched[k], want[k], 1e-4, "commit_sweep_batched D=129")
    for t in range(4):
        single = sweep_ops.commit_sweep(bt["r"][t], bt["m_inv"][t], bt["s"][t],
                                        bt["eta"][t], 64, bt["delta"][t], 1.0, 0.0,
                                        bargs[8][t], True)
        assert all(torch.equal(x[t], y) for x, y in zip(batched, single))
        if t % 2:
            assert torch.equal(batched[0][t], bt["m_inv"][t])


@pytest.mark.parametrize("engine", ["incremental", "fused"])
def test_fit_on_card_matches_cpu(card, engine):
    """Same data on the card (CUDA kernels) and the CPU (plain versions):
    fp32 histories within 1e-4 at D=5, bytes equal, the engine's kernels
    launched."""
    spec = api.ExperimentSpec(data=api.DataSpec(n_train=1000, n_test=500),
                              solver=api.SolverSpec(engine=engine, n_sweeps=5,
                                                    use_kernel=True))
    data = spec.data.build("cpu")
    _build.reset_launches()
    on_card = api.fit(spec, device="cuda", data=data)
    launched = dict(_build.LAUNCHES)
    on_cpu = api.fit(spec, device="cpu", data=data)
    assert on_card.history.bytes_transmitted == on_cpu.history.bytes_transmitted
    for key in ("train_mse", "test_mse", "eta"):
        np.testing.assert_allclose(getattr(on_card.history, key),
                                   getattr(on_cpu.history, key), rtol=1e-4)
    kernels = ("row_gram",) if engine == "incremental" else ("probe_sweep",
                                                             "commit_sweep")
    assert launched["gram"] > 0 and all(launched[k] > 0 for k in kernels)


def test_wrappers_refuse_bad_card_inputs(card):
    r = torch.randn((4, 64), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        gram_ops.gram(r.T.contiguous().T)
    with pytest.raises(ValueError, match="shape"):
        gram_ops.row_gram(torch.randn((63,), device=card), r)
    with pytest.raises(IndexError):
        sweep_ops.probe_sweep(r, torch.eye(4, device=card),
                              torch.ones(4, device=card), 1.0, 4,
                              torch.ones(3, device=card))


def _batch(d, n, b, device):
    """B scenes of `_scene` stacked on a leading trial axis (one step
    schedule for all)."""
    scenes = [_scene(d, n, seed=100 * d + t, device=device) for t in range(b)]
    out = {k: torch.stack([sc[k] for sc in scenes]).contiguous()
           for k in scenes[0] if k != "steps"}
    out["steps"] = scenes[0]["steps"]
    return out


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("d,n", GRAM_CASES)
def test_batched_kernels_match_plain_and_single(card, d, n, b):
    """Each batched kernel against its batched plain version, and slice t
    against the single-trial kernel on trial t, bit for bit (at N % 4 != 0
    the slices start off 16-byte alignment); a commit batch with mixed
    accept and reject keeps the rejected trials bitwise; the batched Gram
    products and probe give the same bits twice and on unaligned copies."""
    sc = _batch(d, n, b, card)
    i = d // 2
    _build.reset_launches()
    got = gram_ops.gram(sc["r"])
    _close(got, gram_ref.gram_batched_ref(sc["r"]), 1e-5, "gram_batched")
    assert torch.equal(got, got.mT)
    rg = gram_ops.row_gram(sc["v"], sc["r"])
    _close(rg, gram_ref.row_gram_batched_ref(sc["v"], sc["r"]), 1e-5,
           "row_gram_batched")
    rg_shared = gram_ops.row_gram(sc["v"][0], sc["r"])
    args = (sc["r"], sc["m_inv"], sc["s"], sc["eta"], i, sc["steps"])
    probe = sweep_ops.probe_sweep(*args)
    for g, w in zip(probe, sweep_ref.probe_sweep_batched_ref(*_f64(args))):
        _close(g, w, 1e-4, "probe_sweep_batched")
    thr = torch.tensor([-((-1.0) ** t) * math.inf for t in range(b)],
                       device=card)                  # accept, reject, accept
    cargs = (sc["r"], sc["m_inv"], sc["s"], sc["eta"], i, sc["delta"], 1.0,
             0.0, thr, True)
    commit = sweep_ops.commit_sweep(*cargs)
    want = sweep_ref.commit_sweep_batched_ref(*cargs)
    assert commit[3].tolist() == want[3].tolist() == [t % 2 == 0 for t in range(b)]
    for k in (0, 1, 2, 4):
        _close(commit[k], want[k], 1e-4, "commit_sweep_batched")
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "gram_batched": 1, "row_gram_batched": 2, "probe_sweep_batched": 1,
        "commit_sweep_batched": 1}
    for t in range(b):
        assert torch.equal(got[t], gram_ops.gram(sc["r"][t]))
        assert torch.equal(rg[t], gram_ops.row_gram(sc["v"][t], sc["r"][t]))
        assert torch.equal(rg_shared[t], gram_ops.row_gram(sc["v"][0], sc["r"][t]))
        single = sweep_ops.probe_sweep(sc["r"][t], sc["m_inv"][t], sc["s"][t],
                                       sc["eta"][t], i, sc["steps"])
        assert all(torch.equal(x[t], y) for x, y in zip(probe, single))
        single = sweep_ops.commit_sweep(sc["r"][t], sc["m_inv"][t], sc["s"][t],
                                        sc["eta"][t], i, sc["delta"][t], 1.0,
                                        0.0, thr[t], True)
        assert all(torch.equal(x[t], y) for x, y in zip(commit, single))
        if t % 2:
            assert torch.equal(commit[0][t], sc["m_inv"][t])
            assert torch.equal(commit[1][t], sc["s"][t])
        else:
            assert torch.equal(commit[0][t], commit[0][t].T)
    # the same bits twice, and again on copies off 16-byte alignment
    assert torch.equal(got, gram_ops.gram(sc["r"]))
    assert torch.equal(rg, gram_ops.row_gram(sc["v"], sc["r"]))
    assert torch.equal(got, gram_ops.gram(_unaligned_copy(sc["r"])))
    assert torch.equal(rg, gram_ops.row_gram(_unaligned_copy(sc["v"]),
                                             _unaligned_copy(sc["r"])))
    assert all(map(torch.equal, probe, sweep_ops.probe_sweep(*args)))
    assert all(map(torch.equal, probe,
                   sweep_ops.probe_sweep(_unaligned_copy(sc["r"]), *args[1:])))


@pytest.mark.parametrize("k", [1, 3, 16])
@pytest.mark.parametrize("d,n", [(100, 20001), (300, 2002)])
def test_probe_step_counts_match_plain(card, d, n, k):
    """The closed-form epilogue at K = 1, 3 and 16 steps, on both routes
    (D=100 registers, D=300 shared memory), one trial and a batch of 2,
    against the plain versions; slice t equals the single-trial launch."""
    sc = _batch(d, n, 2, card)
    steps = sc["steps"][:k].contiguous()
    i = d // 3
    args = (sc["r"], sc["m_inv"], sc["s"], sc["eta"], i, steps)
    probe = sweep_ops.probe_sweep(*args)
    assert probe[0].shape == (2, k)
    for g, w in zip(probe, sweep_ref.probe_sweep_batched_ref(*_f64(args))):
        _close(g, w, 1e-4, f"probe_sweep_batched K={k}")
    for t in range(2):
        targs = (sc["r"][t], sc["m_inv"][t], sc["s"][t], sc["eta"][t], i, steps)
        single = sweep_ops.probe_sweep(*targs)
        for g, w in zip(single, sweep_ref.probe_sweep_ref(*_f64(targs))):
            _close(g, w, 1e-4, f"probe_sweep K={k}")
        assert all(torch.equal(x[t], y) for x, y in zip(probe, single))


@pytest.mark.parametrize("engine", ["incremental", "fused"])
def test_batch_fit_on_card_matches_cpu(card, engine):
    """batch_fit at D=5 on the card (batched CUDA kernels only) against the
    same batch on the CPU: fp32 histories within 1e-4, bytes equal."""
    spec = api.ExperimentSpec(data=api.DataSpec(n_train=1000, n_test=500),
                              solver=api.SolverSpec(engine=engine, n_sweeps=4,
                                                    use_kernel=True))
    _build.reset_launches()
    on_card = api.batch_fit(spec, 3, device="cuda")
    launched = dict(_build.LAUNCHES)
    on_cpu = api.batch_fit(spec, 3, device="cpu")
    for a, b in zip(on_card, on_cpu):
        assert a.history.bytes_transmitted == b.history.bytes_transmitted
        assert a.history.converged_at == b.history.converged_at
        for key in ("train_mse", "test_mse", "eta"):
            np.testing.assert_allclose(getattr(a.history, key),
                                       getattr(b.history, key), rtol=1e-4)
    assert all(launched[k] == 0 for k in ("gram", "row_gram", "probe_sweep",
                                          "commit_sweep"))
    kernels = (("row_gram_batched",) if engine == "incremental"
               else ("probe_sweep_batched", "commit_sweep_batched"))
    assert launched["gram_batched"] == 2 + 3 * 4
    assert all(launched[k] == (2 if engine == "incremental" else 1) * 5 * 4
               for k in kernels)


def test_batched_wrappers_refuse_bad_card_inputs(card):
    r = torch.randn((2, 4, 64), device=card)
    m_inv = torch.eye(4, device=card).expand(2, 4, 4).contiguous()
    s = torch.ones((2, 4), device=card)
    steps = torch.ones(3, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        gram_ops.gram(r.mT.contiguous().mT)
    with pytest.raises(ValueError, match="v of shape"):
        gram_ops.row_gram(torch.randn((3, 64), device=card), r)
    with pytest.raises(ValueError, match="m_inv"):
        sweep_ops.probe_sweep(r, m_inv[:1], s, 1.0, 0, steps)
    with pytest.raises(ValueError, match="per-trial scalars"):
        sweep_ops.probe_sweep(r, m_inv, s, torch.ones(3, device=card), 0, steps)
    with pytest.raises(ValueError, match="delta"):
        sweep_ops.commit_sweep(r, m_inv, s, 1.0, 0,
                               torch.zeros((2, 63), device=card), 1.0, 0.0,
                               0.0, True)
    with pytest.raises(IndexError):
        sweep_ops.commit_sweep(r, m_inv, s, 1.0, 4,
                               torch.zeros((2, 64), device=card), 1.0, 0.0,
                               0.0, True)


# ------------------------------------------------------ Minimax Protection


@pytest.mark.parametrize("m", [20, 2622])
@pytest.mark.parametrize("d", [5, 100])
def test_commit_device_diag_operands_match_plain(card, d, m):
    """The split's commit: diag_keep = 0 and diag_add a 0-d device tensor
    (B7), or one per trial (B8), against the plain versions (1e-4, accept
    flags equal); a Python number and a 0-d tensor of the same value give
    the same bits; slice t of the batch is the single launch with
    diag_add[t]."""
    sc = _scene(d, m, seed=11 * d + m, device=card)
    i = d // 2
    add = torch.tensor(0.037, device=card)
    keep = torch.zeros((), device=card)
    base = (sc["r"], sc["m_inv"], sc["s"], sc["eta"], i, sc["delta"])
    for thr in (float("-inf"), float("inf")):
        got = sweep_ops.commit_sweep(*base, 0.0, add, thr, True)
        want = sweep_ref.commit_sweep_ref(*base, 0.0, add, thr, True)
        assert bool(got[3]) == bool(want[3]) == (thr < 0)
        for k in (0, 1, 2, 4):
            _close(got[k], want[k], 1e-4, f"commit split D={d} m={m}")
        if thr < 0:
            assert float(got[2][i]) == float(add)          # u_i = diag_add
        for same in (sweep_ops.commit_sweep(*base, 0.0, float(add), thr, True),
                     sweep_ops.commit_sweep(*base, keep, add, thr, True)):
            assert all(map(torch.equal, got, same))
    bt = _batch(d, m, 3, card)
    adds = torch.tensor([0.01, -0.02, 0.05], device=card)
    thr = torch.tensor([-math.inf, math.inf, -math.inf], device=card)
    bargs = (bt["r"], bt["m_inv"], bt["s"], bt["eta"], i, bt["delta"], 0.0, adds,
             thr, True)
    before = _build.LAUNCHES["commit_sweep_batched"]
    batched = sweep_ops.commit_sweep(*bargs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["commit_sweep_batched"] == before + 1
    want = sweep_ref.commit_sweep_batched_ref(*bargs)
    assert batched[3].tolist() == want[3].tolist() == [True, False, True]
    for k in (0, 1, 2, 4):
        _close(batched[k], want[k], 1e-4, f"commit_sweep_batched split D={d} m={m}")
    for t in range(3):
        single = sweep_ops.commit_sweep(bt["r"][t], bt["m_inv"][t], bt["s"][t],
                                        bt["eta"][t], i, bt["delta"][t], 0.0,
                                        adds[t], thr[t], True)
        assert all(torch.equal(x[t], y) for x, y in zip(batched, single))


def test_alpha_one_commit_same_bits_by_value_and_tensor(card):
    """At alpha = 1 the commit takes 1.0 and 0.0 by value, as before the
    diag operands could live on the device; passing them as device tensors
    reads the same values and gives the same bits, single and batched."""
    sc = _scene(100, 20001, seed=5, device=card)
    base = (sc["r"], sc["m_inv"], sc["s"], sc["eta"], 30, sc["delta"])
    one, zero = torch.ones((), device=card), torch.zeros((), device=card)
    by_value = sweep_ops.commit_sweep(*base, 1.0, 0.0, float("-inf"), True)
    assert all(map(torch.equal, by_value,
                   sweep_ops.commit_sweep(*base, one, zero, float("-inf"), True)))
    bt = _batch(100, 3001, 2, card)
    bbase = (bt["r"], bt["m_inv"], bt["s"], bt["eta"], 30, bt["delta"])
    by_value = sweep_ops.commit_sweep(*bbase, 1.0, 0.0, float("-inf"), True)
    assert all(map(torch.equal, by_value, sweep_ops.commit_sweep(
        *bbase, one.expand(2).contiguous(), zero.expand(2).contiguous(),
        float("-inf"), True)))


@pytest.mark.parametrize("n", [2000, 262144])
def test_permutation_on_card_equals_cpu(card, n):
    keys = prng.split(prng.PRNGKey([1, 101]), 3)[:, 1]
    on_card = prng.permutation(keys.to(card), n)
    assert on_card.device.type == "cuda"
    assert torch.equal(on_card.cpu(), prng.permutation(keys, n))
    idx = cov.subsample_indices(keys.to(card), n, 100.0)
    assert torch.equal(idx.cpu(), cov.subsample_indices(keys, n, 100.0))


@pytest.mark.parametrize("shape", [(5,), (16, 5), (3, 16, 100)])
def test_robust_weights_graph_matches_eager(card, shape):
    """On the card the robust solver's iterations replay as a CUDA graph:
    the same result as running them eagerly, on a first call (recorded) and
    a second with other inputs (replayed)."""
    gen = torch.Generator(device=card).manual_seed(len(shape))
    d = shape[-1]
    for _ in range(2):
        r = torch.randn(shape[:-1] + (d, 4 * d), generator=gen, device=card)
        a0 = r @ r.mT / (4 * d) + 0.1 * torch.eye(d, device=card)
        a = torch.softmax(torch.randn(shape, generator=gen, device=card), dim=-1)
        got = minimax.robust_weights(a0, 0.02, steps=120, a_init=a)
        want = minimax._descend(a0, a, 0.02, 120, 0.05)
        _close(got, want, 1e-6, f"robust_weights graph {shape}")
    assert any(k[0] == tuple(shape[:-1]) + (d, d) for k in minimax._GRAPHS)


@pytest.mark.parametrize("allow_tf32", [True, False])
def test_robust_weights_graph_keyed_by_tf32(card, allow_tf32):
    """A graph recorded under one TF32 setting is not replayed under the
    other: after a call with the other setting, this setting's call still
    equals the eager iterations run under it."""
    gen = torch.Generator(device=card).manual_seed(11)
    r = torch.randn((100, 400), generator=gen, device=card)
    a0 = r @ r.T / 400 + 0.1 * torch.eye(100, device=card)
    a = torch.softmax(torch.randn((100,), generator=gen, device=card), dim=-1)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = not allow_tf32
        minimax.robust_weights(a0, 0.02, steps=60, a_init=a)
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
        got = minimax.robust_weights(a0, 0.02, steps=60, a_init=a)
        want = minimax._descend(a0, a, 0.02, 60, 0.05)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    _close(got, want, 1e-6, f"robust_weights graph, allow_tf32={allow_tf32}")
    assert {k[-1] for k in minimax._GRAPHS if k[0] == (100, 100)} >= {True, False}


@pytest.mark.parametrize("delta", [0.0, 0.01])
@pytest.mark.parametrize("engine", ["incremental", "fused"])
def test_minimax_fit_on_card_matches_cpu(card, engine, delta):
    """alpha = 20 at D = 5 with kernels on the card against the plain
    versions on the CPU, the same data: fp32 histories within 5e-4 at
    delta = 0 and 1e-3 at delta > 0, bytes equal; the batch likewise.  At
    alpha = 20 a record's weights come from 50 instances and cancel,
    amplifying fp32 differences in the MSE (tests/test_torch_icoa.py
    F32_TOL).  On an NVIDIA H100 80GB HBM3 at 700 W: delta = 0 1.2e-4
    (incremental) and 2.6e-4 (fused), delta = 0.01 3.6e-4; planted faults
    on the card side fail both bounds: the commit's diag_add left out
    1.8e-3, the exact diagonal's change left out of the incremental update
    1.9e-3 (delta = 0) and 2.6 (delta = 0.01), a batch trial reading trial
    0's diagonal change 3.9e-3 and 0.75."""
    spec = api.ExperimentSpec(data=api.DataSpec(n_train=1000, n_test=500),
                              solver=api.SolverSpec(engine=engine, n_sweeps=3,
                                                    alpha=20.0, delta=delta,
                                                    minimax_steps=100,
                                                    use_kernel=True))
    tol = 5e-4 if delta == 0.0 else 1e-3
    data = spec.data.build("cpu")
    pairs = [(api.fit(spec, device="cuda", data=data),
              api.fit(spec, device="cpu", data=data))]
    pairs += list(zip(api.batch_fit(spec, 2, device="cuda"),
                      api.batch_fit(spec, 2, device="cpu")))
    for on_card, on_cpu in pairs:
        assert on_card.history.bytes_transmitted == on_cpu.history.bytes_transmitted
        for key in ("train_mse", "test_mse", "eta"):
            np.testing.assert_allclose(getattr(on_card.history, key),
                                       getattr(on_cpu.history, key), rtol=tol)


# ------------------------------------------------ data drawn on the card

DRAW_RANGES = [(0.0, 1.0), (1.0, 100.0), (40.0 * math.pi, 560.0 * math.pi)]


def _ulp(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    it = torch.int32 if got.dtype == torch.float32 else torch.int64
    a, b = (x.view(it).to(torch.int64) for x in (got, want))
    lo = torch.iinfo(it).min
    a = torch.where(a < 0, lo - a, a)
    b = torch.where(b < 0, lo - b, b)
    return (a - b).abs()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_card_uniforms_and_words_equal_cpu(card, dtype):
    keys = prng.split(prng.PRNGKey(3), 4)
    for lo, hi in DRAW_RANGES:
        want = prng.uniform(keys, (5, 3001), dtype, lo, hi)
        assert torch.equal(prng.uniform(keys.to(card), (5, 3001), dtype,
                                        lo, hi).cpu(), want)
    for width in (32, 64):
        assert torch.equal(prng.bits(keys.to(card), (777,), width).cpu(),
                           prng.bits(keys, (777,), width))
    assert torch.equal(prng.fold_in(keys.to(card), 2**31 + 5).cpu(),
                       prng.fold_in(keys, 2**31 + 5))


@pytest.mark.parametrize("dtype,max_ulp", [(torch.float32, 0),
                                           (torch.float64, 4)],
                         ids=["f32", "f64"])
def test_card_normals_within_ulp_of_cpu(card, dtype, max_ulp):
    key = prng.PRNGKey(7)
    got = prng.normal(key.to(card), (200_000,), dtype).cpu()
    d = _ulp(got, prng.normal(key, (200_000,), dtype))
    assert int(d.max()) <= max_ulp, (int(d.max()), float((d == 0).double().mean()))


@pytest.mark.parametrize("source", ["friedman2", "correlated_linear", "cosine"])
def test_card_trial_batch_equals_single_draws(card, source):
    from repro_torch.data import sources as data_sources

    n_attrs, groups = (None, [[j] for j in range(5)]) if source == "friedman2" \
        else (6, [[0, 1], [2, 3], [4, 5]])
    seeds = [0, 5, 2]
    batch = data_sources.make_trial_batch(source, 3000, 700, seeds, groups,
                                          noise=0.1, n_attrs=n_attrs,
                                          device=card)
    for b, seed in enumerate(seeds):
        xtr, ytr, xte, yte = data_sources.make_dataset(
            source, 3000, 700, seed, noise=0.1, n_attrs=n_attrs, device=card)
        single = (data_sources.partition_columns(xtr, groups), ytr,
                  data_sources.partition_columns(xte, groups), yte)
        cpu = data_sources.make_dataset(source, 3000, 700, seed, noise=0.1,
                                        n_attrs=n_attrs)
        for got, want in zip(batch, single):
            assert torch.equal(got[b], want)
        for got, want in zip((xtr, ytr, xte, yte), cpu):      # normwise
            assert float((got.cpu() - want).abs().max()) <= 2e-6 * max(
                1.0, float(want.abs().max()))


@pytest.mark.parametrize("alpha,delta", [(1.0, 0.0), (20.0, 0.01)])
def test_card_dense_batch_matches_single_runs(card, alpha, delta):
    """The batched dense engine on the card in float64: each trial's
    history within 1e-10 of the single-trial dense run of its spec."""
    dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        spec = api.ExperimentSpec(
            data=api.DataSpec(n_train=400, n_test=200),
            solver=api.SolverSpec(engine="dense", n_sweeps=2, eps=0.0,
                                  alpha=alpha, delta=delta, minimax_steps=60))
        rs = api.batch_fit(spec, 3, device="cuda")
        for t, res in enumerate(rs):
            one = api.fit(api.trial_spec(spec, t), device="cuda")
            assert res.history.bytes_transmitted == one.history.bytes_transmitted
            for key in ("train_mse", "test_mse", "eta"):
                np.testing.assert_allclose(getattr(res.history, key),
                                           getattr(one.history, key), rtol=1e-10)
    finally:
        torch.set_default_dtype(dt)


def test_card_result_saves_and_loads_on_card(card, tmp_path):
    spec = api.ExperimentSpec(data=api.DataSpec(n_train=500, n_test=200),
                              solver=api.SolverSpec(engine="fused",
                                                    use_kernel=True, n_sweeps=3))
    res = api.fit(spec, device="cuda")
    res.save(str(tmp_path))
    back = api.load(str(tmp_path), device="cuda")
    assert back.params.is_cuda and back.history.as_dict() == res.history.as_dict()
    for name in ("params", "weights", "f"):
        assert torch.equal(getattr(back, name), getattr(res, name))
    x = res.data.xcols_test[:, :, 0].T.contiguous()
    assert torch.equal(back.predict(x), res.predict(x))
    for got, want in zip(back.data[:4], res.data[:4]):
        assert torch.equal(got, want)


# ---------------------------------------------------------------- transport

def _batched_scene(b, d, n, seed, device):
    scenes = [_scene(d, n, seed + t, device) for t in range(b)]
    return {k: torch.stack([s[k] for s in scenes]).contiguous()
            for k in ("r", "m_inv", "s", "eta", "delta")} | {"steps": scenes[0]["steps"]}


@pytest.mark.parametrize("d,n", [(5, 600), (100, 20001), (129, 4096)])
def test_per_trial_agents_equal_the_single_launch(card, d, n):
    """B6 and B8 with one agent per trial: slice b equals the single-trial
    kernel on agent i[b] bit for bit; the null-index (one agent) path
    equals it too, and a trial whose can_tx is false keeps its state."""
    b = 4
    sc = _batched_scene(b, d, n, 40, card)
    agents = torch.tensor([d - 1, 0, d // 2, d - 1], device=card)
    can = torch.tensor([True, False, True, True], device=card)
    thr = sc["eta"] - 1.0
    probe = sweep_ops.probe_sweep(sc["r"], sc["m_inv"], sc["s"], sc["eta"],
                                  agents, sc["steps"])
    commit = sweep_ops.commit_sweep(sc["r"], sc["m_inv"], sc["s"], sc["eta"],
                                    agents, sc["delta"], 1.0, 0.0, thr, can)
    shared = sweep_ops.probe_sweep(sc["r"], sc["m_inv"], sc["s"], sc["eta"], 0,
                                   sc["steps"])
    for t in range(b):
        i = int(agents[t])
        one_p = sweep_ops.probe_sweep(sc["r"][t], sc["m_inv"][t], sc["s"][t],
                                      sc["eta"][t], i, sc["steps"])
        one_c = sweep_ops.commit_sweep(sc["r"][t], sc["m_inv"][t], sc["s"][t],
                                       sc["eta"][t], i, sc["delta"][t], 1.0, 0.0,
                                       thr[t], bool(can[t]))
        assert all(torch.equal(g[t], w) for g, w in zip(probe, one_p)), t
        assert all(torch.equal(g[t], w) for g, w in zip(commit, one_c)), t
        zero_p = sweep_ops.probe_sweep(sc["r"][t], sc["m_inv"][t], sc["s"][t],
                                       sc["eta"][t], 0, sc["steps"])
        assert all(torch.equal(g[t], w) for g, w in zip(shared, zero_p)), t
    assert not bool(commit[3][1])
    assert torch.equal(commit[0][1], sc["m_inv"][1])
    assert torch.equal(commit[1][1], sc["s"][1])
    want = sweep_ref.commit_sweep_batched_ref(sc["r"], sc["m_inv"], sc["s"],
                                              sc["eta"], agents, sc["delta"],
                                              1.0, 0.0, thr, can)
    assert torch.equal(commit[3], want[3])
    _close(commit[1], want[1], 1e-4, "commit s per trial")


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_card_codecs_equal_the_cpu(card, x64):
    """int8_affine (its decode one addcmul, a fused multiply-add, on the
    card; the exact FMA emulation on the CPU), topk_sparse with ties, and
    exact_bf16: the card's round trip equals the CPU's bit for bit."""
    from repro_torch import transport as ttr

    dt = torch.float64 if x64 else torch.float32
    rng = np.random.default_rng(9)
    x = torch.tensor(rng.standard_normal((8, 5000)) * rng.random((8, 1)) * 7,
                     dtype=dt)
    x[1] = 0.75
    x[2, :100] = 1.5
    x[2, 200:300] = -1.5
    for name, opts in (("int8_affine", ()), ("topk_sparse", (("k", 64),)),
                       ("topk_sparse", (("k", 150),)), ("exact_bf16", ())):
        codec = ttr.build_codec(name, opts)
        got = codec.roundtrip(x.to(card))
        assert torch.equal(got.cpu(), codec.roundtrip(x)), name
    tp = ttr.Transport(topology=ttr.build_topology("ring", 8),
                       codec=ttr.build_codec("int8_affine"))
    assert torch.equal(tp.relay_rows(x.to(card)).cpu(), tp.relay_rows(x))


@pytest.mark.parametrize("engine", ["fused", "incremental"])
def test_budgeted_batch_fit_on_star_on_card(card, engine):
    """A budgeted batch (star, greedy_eta, 0.75 x one sweep's price) on the
    card: the per-trial ledgers equal the CPU's on the same data and
    diverge, each within the budget; every trial within 1e-4 of the CPU;
    under the fused engine B6 and B8 take one agent per trial."""
    from repro_torch import transport as ttr
    from repro_torch.core import icoa
    from repro_torch.data import sources

    star = api.TransportSpec(topology="star")
    price = ttr.icoa_sweep_cost(star.resolve(5), 400, split=False, row_wise=True)
    spec = api.ExperimentSpec(
        data=api.DataSpec(n_train=400, n_test=200),
        transport=dataclasses.replace(star, byte_budget=0.75 * price),
        solver=api.SolverSpec(engine=engine, use_kernel=True, n_sweeps=2,
                              eps=0.0))
    _build.reset_launches()
    rs = api.batch_fit(spec, 8, device="cuda")
    per_trial = _build.LAUNCHES["probe_sweep_batched_per_trial"]
    assert per_trial == (10 if engine == "fused" else 0)
    seeds = list(range(8))
    dd = spec.data
    cpu = [a.cpu() for a in sources.make_trial_batch(
        dd.source, dd.n_train, dd.n_test, seeds, dd.groups, device="cuda")]
    cfg = spec.solver.icoa_config(spec.resolved_transport())
    ref = icoa.run_scan(rs[0].family, cfg, *cpu, seeds=seeds)[3]
    ledgers = [r.history.bytes_transmitted for r in rs]
    assert ledgers == ref["trial_bytes"]
    assert len({tuple(b) for b in ledgers}) > 1
    assert all(sum(b) <= 0.75 * price for b in ledgers)
    for t, res in enumerate(rs):
        np.testing.assert_allclose(res.history.eta, ref["eta"][t].numpy(),
                                   rtol=1e-4)


# ------------------------------------------- the C library's sin / cos, faults


def test_libm_on_card_equals_cpu(card):
    """glibc's float32 sinf / cosf / atanf written in tensor operations
    (data.libm): the card's bits equal the CPU's (which equal the C
    library's, tests/test_torch_families.py) over every reduction branch."""
    from repro_torch.data import libm

    rng = np.random.default_rng(0)
    n = 200_000
    x = np.concatenate([rng.uniform(-1, 1, n), rng.uniform(-130, 130, n),
                        rng.uniform(-1e6, 1e6, n),
                        np.exp(rng.uniform(-100, 88, n)) * rng.choice([-1, 1], n),
                        [0.0, -0.0, np.inf, -np.inf, np.nan, 120.0, 0.75,
                         2.0 ** 25, 1e-40]]).astype(np.float32)
    xt = torch.from_numpy(x)
    for fn in (libm.sinf, libm.cosf, libm.atanf):
        got = fn(xt.to(card)).cpu().numpy()
        want = fn(xt).numpy()
        same = (got.view(np.int32) == want.view(np.int32)) | (np.isnan(got) & np.isnan(want))
        assert same.all(), fn.__name__


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_corrupt_on_card_equals_cpu(card, x64):
    """The fault trace's bit flips drawn on the card equal the CPU's: one
    row (through `corrupt` and the engines' RoundTrace.strike), and one
    row per trial with one agent each."""
    from repro_torch.faults import FaultSpec, RoundTrace, corrupt

    dt = torch.float64 if x64 else torch.float32
    spec = FaultSpec(seed=9, corrupt_rate=0.7, corrupt_bits=12)
    rows = torch.randn((6, 3000), dtype=dt, generator=torch.Generator().manual_seed(1))
    for r in range(3):
        rt = RoundTrace(spec, r, 4, dt)
        for a in range(4):
            want = corrupt(spec, rows[0], r, a)
            assert torch.equal(corrupt(spec, rows[0].to(card), r, a).cpu(), want)
            assert torch.equal(rt.strike(rows[0].to(card), a).cpu(), want)
        agents = [0, 3, 1, 2, 2, 0]
        assert torch.equal(corrupt(spec, rows.to(card), r, agents).cpu(),
                           corrupt(spec, rows, r, agents))


def test_fault_gated_commits_leave_the_state(card):
    """A commit gated off by the fault trace (dead, straggling or
    undelivered: can_tx False) on a struck row leaves m_inv and s bit for
    bit, single (by value) and batched (a device vector)."""
    from repro_torch.faults import FaultSpec, corrupt

    d, n, b = 7, 4000, 4
    sc = _scene(d, n, 3, card)
    r, m_inv, s, eta = sc["r"], sc["m_inv"], sc["s"], sc["eta"]
    spec = FaultSpec(seed=2, corrupt_rate=1.0, corrupt_bits=8)
    delta = corrupt(spec, 0.05 * torch.randn(n, device=card), 0, 2)
    out = sweep_ops.commit_sweep(r, m_inv, s, eta, 2, delta, 1.0, 0.0,
                                 eta - 1.0, False)
    assert not bool(out[3]) and torch.equal(out[0], m_inv) and torch.equal(out[1], s)
    rb = r[None].expand(b, d, n).contiguous()
    mb = m_inv[None].expand(b, d, d).contiguous()
    sb, eb = s[None].expand(b, d).contiguous(), eta.expand(b).contiguous()
    db = delta[None].expand(b, n).contiguous()
    can = torch.tensor([True, False, True, False], device=card)
    outb = sweep_ops.commit_sweep(rb, mb, sb, eb, 2, db, 1.0, 0.0, eb - 1.0, can)
    for t in (1, 3):
        assert not bool(outb[3][t])
        assert torch.equal(outb[0][t], mb[t]) and torch.equal(outb[1][t], sb[t])


def test_fault_fit_on_card_matches_cpu(card):
    """Every fault at once on the paper cell (4 sweeps, fused, use_kernel):
    bytes equal to the CPU's on the same data, histories within 1e-4, and
    agent 1 (down for rounds 1 and 2) weighs exactly 0 after sweep 2."""
    from repro_torch.faults import FaultSpec

    faults = FaultSpec(seed=5, drop_rate=0.3, corrupt_rate=0.2, corrupt_bits=4,
                       straggle_rate=0.1, max_retries=2, crash=((1, 1, 3),))
    for sweeps in (2, 4):
        spec = api.ExperimentSpec(
            data=api.DataSpec(n_train=600, n_test=300), faults=faults,
            solver=api.SolverSpec(engine="fused", use_kernel=True,
                                  n_sweeps=sweeps, eps=0.0))
        data = spec.data.build("cuda")
        res = api.fit(spec, device="cuda", data=data)
        cpu = api.fit(spec, device="cpu", data=data)
        assert res.history.bytes_transmitted == cpu.history.bytes_transmitted
        np.testing.assert_allclose(res.history.eta, cpu.history.eta, rtol=1e-4)
        assert (res.weights[1].item() == 0.0) == (sweeps == 2)


def test_mlp_fit_on_card_within_bound_of_cpu(card):
    """The mlp family's fit (4 agents batched, 60 Adam steps, float64 with
    its float32 biases) on the card against the CPU: predictions within
    1e-9 of each other (the CPU run is within ~1e-15 of the JAX package's,
    tests/test_torch_families.py; the card's tanh and the sums over N round
    differently in the last bits, and a float32 bias update can round a
    step apart)."""
    from repro_torch.agents import MLPFamily

    fam = MLPFamily(n_cols=1, hidden=16, fit_steps=60)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((4, 500, 1), dtype=torch.float64, generator=gen)
    y = torch.sin(2 * x[..., 0])
    p0 = fam.init(prng.split(prng.PRNGKey(2), 4), torch.float64)
    want = fam.predict(fam.fit(p0, x, y), x)
    p0c = {k: v.to(card) for k, v in p0.items()}
    got = fam.predict(fam.fit(p0c, x.to(card), y.to(card)), x.to(card)).cpu()
    assert float((got - want).abs().max()) <= 1e-9


# ------------------------------------------------------------- LM kernels

LM_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


def _lm(seed, *shapes, dtype, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(s, generator=gen, device=device).to(dtype) for s in shapes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,dh,causal,window", [
    (2, 150, 150, 15, 5, 64, True, 0),     # G = 3, ragged tiles
    (1, 77, 77, 3, 1, 80, True, 16),       # the smollm smoke heads, window
    (2, 40, 93, 4, 2, 64, False, 0),       # non-causal, ragged Skv
    (1, 96, 96, 8, 1, 128, True, 32),      # G = 8, window inside a tile
])
def test_flash_attention_matches_plain(card, dtype, b, sq, skv, hq, hkv, dh,
                                       causal, window):
    q, k, v = _lm(sq, (b, sq, hq, dh), (b, skv, hkv, dh), (b, skv, hkv, dh),
                  dtype=dtype, device=card)
    before = _build.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and _build.LAUNCHES["flash_attention"] == before + 1
    _close(got, attention_ref(q, k, v, causal=causal, window=window),
           LM_TOL[dtype], "flash_attention")
    assert torch.equal(got, flash_attention(q, k, v, causal=causal, window=window))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,s,hq,hkv,dh,idx,window", [
    (2, 96, 6, 2, 64, 0, 0),          # one position
    (8, 1088, 15, 5, 64, 517, 0),     # G = 3, idx mid-cache
    (2, 300, 3, 1, 80, 299, 64),      # the smollm smoke heads, window
    (3, 999, 8, 1, 128, 700, 0),      # G = 8
    (8, 1088, 128, 8, 128, 1087, 0),  # G = 16: llama3-405b's serving heads
    (2, 500, 32, 2, 64, 400, 0),      # G = 16 at dh 64
    (1, 4000, 16, 1, 128, 3999, 0),   # G = 16 over many chunks
    (2, 300, 12, 1, 128, 299, 37),    # G = 12: unequal halves, window
])
def test_flash_decode_matches_plain(card, dtype, b, s, hq, hkv, dh, idx, window):
    q, k, v = _lm(s + idx, (b, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh),
                  dtype=dtype, device=card)
    before = _build.LAUNCHES["flash_decode"]
    got = flash_decode(q, k, v, idx, window=window)
    assert got.dtype == dtype and _build.LAUNCHES["flash_decode"] == before + 1
    _close(got, decode_ref(q, k, v, idx, window=window), LM_TOL[dtype], "flash_decode")
    assert torch.equal(got, flash_decode(q, k, v, idx, window=window))   # same bits


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,causal,window", [
    (2, 200, 200, 15, 5, True, 0),     # G = 3, Sq not a multiple of 128
    (1, 100, 300, 8, 1, False, 0),     # G = 8, Skv > Sq, non-causal, ragged
    (1, 300, 300, 6, 2, True, 16),     # window < one key tile: rows with a
                                       # wholly masked tile in their warpgroup
    (1, 260, 260, 8, 1, True, 100),    # G = 8, window, three query tiles
    (2, 1, 1, 4, 4, True, 0),          # a single row
    (1, 1, 77, 3, 1, False, 0),        # a single row over a ragged Skv
])
def test_flash_attention_tc_matches_plain(card, dh, b, sq, skv, hq, hkv, causal, window):
    """The bf16 tensor-core kernel (ROUTES: bf16 at dh 64 and 128) against
    the plain version at 8e-3, and the same bits from a second call."""
    q, k, v = _lm(sq + dh, (b, sq, hq, dh), (b, skv, hkv, dh), (b, skv, hkv, dh),
                  dtype=torch.bfloat16, device=card)
    before = dict(_build.LAUNCHES)
    got = flash_attention(q, k, v, causal=causal, window=window)
    again = flash_attention(q, k, v, causal=causal, window=window)
    assert _build.LAUNCHES["flash_attention_tc"] == before["flash_attention_tc"] + 2
    assert _build.LAUNCHES["flash_attention"] == before["flash_attention"] + 2
    _close(got, attention_ref(q, k, v, causal=causal, window=window),
           LM_TOL[torch.bfloat16], "flash_attention tc")
    assert torch.equal(got, again)


@pytest.mark.parametrize("dh,itemsize,want", [(64, 2, 64), (80, 2, 32), (128, 2, 32),
                                              (64, 4, 32), (80, 4, 16), (128, 4, 16)])
def test_decode_tile_positions(card, dh, itemsize, want):
    """The kernel's tile as its library reports it: 8 KB of K at dh 64 and
    128, 5 KB at 80; no tile for a head dim it does not serve."""
    from repro_torch.kernels.flash_decode.ops import max_group, tile_positions

    tile = tile_positions(dh, itemsize)
    assert tile == want and tile * dh * itemsize <= 8192
    assert tile_positions(96, itemsize) == 0 and max_group() == 16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_decode_split_and_back_to_back(card, dtype):
    """A cache long enough for many chunks at B=1 (the in-launch merge), then
    a call of another geometry and the first again: each against the plain
    version, and the first call's bits unchanged (the arrival counters were
    left zero)."""
    from repro_torch.kernels.flash_decode.ops import decode_geometry, tile_positions

    calls = [((1, 5000, 15, 5, 64), 4999, 0), ((2, 3000, 8, 2, 128), 2500, 1000),
             ((1, 5000, 15, 5, 64), 4999, 0)]
    outs = []
    for (b, s, hq, hkv, dh), idx, window in calls:
        q, k, v = _lm(s, (b, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh), dtype=dtype,
                      device=card)
        lo = max(0, idx - window + 1) if window else 0
        _, nsplit = decode_geometry(idx + 1 - lo, b * hkv, tile_positions(dh, q.element_size()))
        assert nsplit > 1
        got = flash_decode(q, k, v, idx, window=window)
        _close(got, decode_ref(q, k, v, idx, window=window), LM_TOL[dtype], "flash_decode")
        outs.append(got)
    assert torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("b,s,h,dh", [(2, 333, 4, 64), (1, 77, 8, 32), (3, 50, 2, 64)])
def test_wkv_matches_plain(card, b, s, h, dh):
    r, k, v, z = _lm(s + dh, *[(b, s, h, dh)] * 4, dtype=torch.float32, device=card)
    w = torch.exp(-torch.exp(z - 1.0))
    u = 0.1 * _lm(1, (h, dh), dtype=torch.float32, device=card)[0]
    out, state = wkv_chunked(r, k, v, w, u)
    want, want_state = wkv_ref(r, k, v, w, u)
    _close(out, want, 1e-5, "wkv out")
    _close(state, want_state, 1e-5, "wkv state")
    assert torch.equal(out, wkv_chunked(r, k, v, w, u)[0])   # same bits again


def _wkv_operands(seed, b, s, h, dh, decay, device):
    """r, k, v, u and w = exp(-exp(z + shift)), z ~ N(0, 1): shift +1 is strong
    decay (log w down to about -e^4 a token, where the JAX package's chunked
    form overflows), -1 moderate, -6 weak (w near 1, rwkv6's slowest base
    decay, where the state grows largest)."""
    r, k, v, z = _lm(seed, *[(b, s, h, dh)] * 4, dtype=torch.float32, device=device)
    w = torch.exp(-torch.exp(z + {"strong": 1.0, "moderate": -1.0, "weak": -6.0}[decay]))
    u = 0.1 * _lm(seed + 1, (h, dh), dtype=torch.float32, device=device)[0]
    return r, k, v, w, u


# b, s, h, dh, decay: B*H from 1 to 256; S = 1, 5, C - 1, C + 1 and 1024
# (C = CHUNK = 16), a single partial chunk up to 64 whole ones
WKV_EDGE_CASES = [
    (1, 1, 1, 64, "strong"),
    (1, 5, 1, 32, "strong"),
    (2, CHUNK - 1, 3, 64, "moderate"),
    (2, CHUNK + 1, 2, 32, "strong"),
    (1, 1024, 1, 32, "weak"),
    (2, 1024, 4, 64, "strong"),
    (8, 1024, 32, 64, "weak"),
    (8, 1024, 32, 64, "strong"),
]


@pytest.mark.parametrize("b,s,h,dh,decay", WKV_EDGE_CASES)
def test_wkv_edges_match_plain(card, b, s, h, dh, decay):
    """Out and final state within 1e-5 of the exact recurrence and of the
    kernel's own algorithm in PyTorch, every value finite, the same bits twice."""
    r, k, v, w, u = _wkv_operands(b * s + dh, b, s, h, dh, decay, card)
    out, state = wkv_chunked(r, k, v, w, u)
    assert torch.isfinite(out).all() and torch.isfinite(state).all()
    want, want_state = wkv_ref(r, k, v, w, u)
    _close(out, want, 1e-5, "wkv out vs recurrence")
    _close(state, want_state, 1e-5, "wkv state vs recurrence")
    safe, safe_state = wkv_safe_chunked_ref(r, k, v, w, u, CHUNK)
    _close(out, safe, 1e-5, "wkv out vs safe chunked")
    _close(state, safe_state, 1e-5, "wkv state vs safe chunked")
    again, again_state = wkv_chunked(r, k, v, w, u)
    assert torch.equal(out, again) and torch.equal(state, again_state)


def test_wkv_four_byte_path_gives_the_same_bits(card):
    """Operands that start 4 bytes off 16-byte alignment take the 4-byte copy
    path, which moves the same values: the same bits come back."""
    r, k, v, w, u = _wkv_operands(3, 2, 77, 4, 64, "moderate", card)
    out, state = wkv_chunked(r, k, v, w, u)
    got, got_state = wkv_chunked(*map(_unaligned_copy, (r, k, v, w)), u)
    assert torch.equal(out, got) and torch.equal(state, got_state)


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_wkv_shared_memory_matches_python(card, dh):
    assert _build.query("wkv", "repro_wkv_smem", dh) == wkv_smem_bytes(dh)


def test_lm_wrappers_refuse_bad_card_inputs(card):
    q, k, v = _lm(0, (1, 16, 4, 64), (1, 16, 2, 64), (1, 16, 2, 64),
                  dtype=torch.float32, device=card)
    with pytest.raises(ValueError, match="CUDA"):              # mixed devices
        flash_attention(q, k.cpu(), v)
    with pytest.raises(TypeError, match="bf16 or all fp32"):   # mixed dtypes
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(TypeError, match="bf16 or all fp32"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                        v[..., :48].contiguous())
    with pytest.raises(api.NotPortedError, match="A16"):    # chunked prefill
        layers.attention_scores(q, k, v, causal=True, q_offset=8)
    with pytest.raises(ValueError, match="contiguous"):
        flash_decode(q[:, 0], k.transpose(1, 2).contiguous().transpose(1, 2), v, 3)
    with pytest.raises(ValueError, match="group"):             # G = 32 > 16
        qq = _lm(1, (1, 32, 64), dtype=torch.float32, device=card)[0]
        flash_decode(qq, k[:, :, :1].contiguous(), v[:, :, :1].contiguous(), 3)
    r = _lm(2, (1, 16, 2, 64), dtype=torch.float32, device=card)[0]
    u = torch.zeros((2, 64), device=card)
    with pytest.raises(TypeError, match="fp32"):
        wkv_chunked(r.bfloat16(), r.bfloat16(), r.bfloat16(), r.bfloat16(), u)
    with pytest.raises(ValueError, match="shape"):
        wkv_chunked(r, r, r, r, torch.zeros((2, 32), device=card))


@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-1.6b", "mixtral-8x22b",
                                  "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b"])
def test_serve_smoke_on_card_matches_cpu(card, arch):
    """The smoke config's prefill and greedy decode on the card (the LM
    kernels) against the CPU (plain versions) from the same parameters:
    logits within 1e-4 normwise, tokens equal, the kernels launched (once a
    prefill and once a step in each attention layer: Jamba's smoke config
    has one, beside a Mamba layer).  mixtral's 80-token prompt passes its
    sliding window of 64."""
    model = build_model(get_config(arch, smoke=True))
    params = model.init(seed=0, device="cpu")
    prompt_len = 80 if arch.startswith("mixtral") else 24
    runs = {}
    for dev in ("cuda", "cpu"):
        recorder = _LogitRecorder(model)
        p = params if dev == "cpu" else _to(params, card)
        _build.reset_launches()
        out, _ = ServeEngine(recorder).generate(
            p, build_prompt(model.cfg, 2, prompt_len, dev), 5)
        runs[dev] = (out.cpu(), [lg.cpu() for lg in recorder.logits],
                     dict(_build.LAUNCHES))
    (tok_g, log_g, launched), (tok_c, log_c, _) = runs["cuda"], runs["cpu"]
    for g, c in zip(log_g, log_c):
        _close(g, c, 1e-4, f"{arch} logits")
    assert torch.equal(tok_g, tok_c)
    n_attn = model.cfg.layer_kinds().count("attn")
    want = ({"flash_attention": n_attn, "flash_decode": 5 * n_attn} if n_attn
            else {"wkv": model.cfg.n_layers})
    assert {k: v for k, v in launched.items() if v} == want


@pytest.mark.parametrize("arch", ["whisper-medium", "qwen2-vl-7b"])
def test_serve_encdec_and_vlm_smoke_on_card_matches_cpu(card, arch):
    """The enc-dec and vlm smoke configs served on the card (B9 for the
    encoder, the decoder's self and cross prefill; B10 for decode self at
    idx and cross at n_frames - 1) against the CPU from the same parameters
    and prompt: logits within 1e-4 normwise, tokens equal, the launches
    exactly those of the layers' attention calls."""
    model = build_model(get_config(arch, smoke=True))
    params = model.init(seed=0, device="cpu")
    prompt = build_prompt(model.cfg, 2, 24, "cpu", seed=0)
    runs = {}
    for dev in ("cuda", "cpu"):
        recorder = _LogitRecorder(model)
        _build.reset_launches()
        out, _ = ServeEngine(recorder).generate(_to(params, dev), _to(prompt, dev), 5)
        runs[dev] = (out.cpu(), [lg.cpu() for lg in recorder.logits],
                     dict(_build.LAUNCHES))
    (tok_g, log_g, launched), (tok_c, log_c, _) = runs["cuda"], runs["cpu"]
    for g, c in zip(log_g, log_c):
        _close(g, c, 1e-4, f"{arch} logits")
    assert torch.equal(tok_g, tok_c)
    cfg = model.cfg
    calls = (cfg.n_enc_layers + 2 * cfg.n_layers, 2 * cfg.n_layers) if arch.startswith(
        "whisper") else (cfg.n_layers, cfg.n_layers)
    assert {k: v for k, v in launched.items() if v} == {
        "flash_attention": calls[0], "flash_decode": 5 * calls[1]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_decode_is_b10_over_every_key(card, dtype):
    """One non-causal query token over whisper's 1500 encoder keys (G = 1,
    dh 64): on the card one B10 launch at idx 1499, against the CPU's
    non-causal plain attention (fp32 1e-5, bf16 8e-3 normwise)."""
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(shape, generator=gen, dtype=torch.float32, device="cpu").to(dtype)
               for shape in ((3, 1, 16, 64), (3, 1500, 16, 64), (3, 1500, 16, 64)))
    want = layers.attention_scores(q.float(), k.float(), v.float(), causal=False)
    _build.reset_launches()
    got = layers.attention_scores(q.to(card), k.to(card), v.to(card), causal=False)
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == {"flash_decode": 1}
    _close(got.float().cpu(), want, 1e-5 if dtype == torch.float32 else 8e-3, "cross decode")


def _forced_logits(model, params, prompt, forced):
    """Prefill logits, then one decode step per column of `forced` (B, K)
    fed those tokens, as fp32 CPU tensors."""
    logits, cache = model.prefill(params, {"tokens": prompt})
    s0 = prompt.shape[1]
    cache = _pad_cache(cache, s0 + forced.shape[1])
    out = [logits]
    for j in range(forced.shape[1]):
        logits, cache = model.decode_step(params, {"tokens": forced[:, j:j + 1],
                                                   "idx": s0 + j}, cache)
        out.append(logits)
    return [x.float().cpu() for x in out]


def _normwise(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def test_serve_bf16_tensor_core_route_matches_cpu(card):
    """bf16 serving end to end through B9's tensor-core kernel: the smollm
    smoke config at head dim 64 (bf16 at dh 64 takes the wgmma kernel; at
    the smoke config's dh 80 the FMA one) served in bf16 on the card, every
    prefill layer on the tensor-core route.  Its prefill and decode logits
    (the CPU fed the card's greedy tokens) lie within 2x the port's own CPU
    bf16-vs-fp32 gap of the port's CPU bf16 logits: the card rounds P to
    bf16 and sums in other orders, which the CPU's bf16 run does not, so
    the bound is the size of a bf16 error on these inputs."""
    cfg32 = dataclasses.replace(get_config("smollm-360m", smoke=True), head_dim=64)
    cfg16 = dataclasses.replace(cfg32, param_dtype="bfloat16", compute_dtype="bfloat16")
    model16, model32 = build_model(cfg16), build_model(cfg32)
    params16 = model16.init(seed=0, device="cpu")
    params32 = _to(params16, torch.float32)            # the same values, exactly
    prompt = build_prompt(cfg16, 2, 24, "cpu")["tokens"]
    params_card = _to(params16, card)
    _build.reset_launches()
    forced, _ = ServeEngine(model16).generate(params_card, {"tokens": prompt.to(card)}, 4)
    torch.cuda.synchronize()
    n = cfg16.n_layers
    assert _build.LAUNCHES["flash_attention_tc"] == _build.LAUNCHES["flash_attention"] == n
    assert _build.LAUNCHES["flash_decode"] == 4 * n
    on_card = _forced_logits(model16, params_card, prompt.to(card), forced)
    forced = forced.cpu()
    cpu16 = _forced_logits(model16, params16, prompt, forced)
    cpu32 = _forced_logits(model32, params32, prompt, forced)
    for k, (g, w16, w32) in enumerate(zip(on_card, cpu16, cpu32)):
        assert bool(torch.isfinite(g).all())
        gap = _normwise(w16, w32)
        assert 0.0 < gap < 0.1, (k, gap)
        err = _normwise(g, w16)
        assert err <= 2 * gap, f"step {k}: card vs cpu bf16 {err:.3e} > 2 x gap {gap:.3e}"


class _LogitRecorder:
    """The model, recording the logits of its prefill and decode steps."""

    def __init__(self, model):
        self.model, self.cfg, self.logits = model, model.cfg, []

    def prefill(self, p, batch):
        out, cache = self.model.prefill(p, batch)
        self.logits.append(out)
        return out, cache

    def decode_step(self, p, batch, cache):
        out, cache = self.model.decode_step(p, batch, cache)
        self.logits.append(out)
        return out, cache


def _to(tree, device):
    """The tree on `device`, or cast to a floating dtype."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return [_to(v, device) for v in tree]


# ------------------------------------------------------ observability, stream

ALL_TAPS = ("accepts", "budget_rejects", "codec_error", "eta",
            "fault_retries", "s")


def test_taps_on_card_match_cpu(card):
    spec = api.ExperimentSpec(
        solver=api.SolverSpec(engine="fused", use_kernel=True, n_sweeps=4,
                              eps=0.0),
        faults=api.FaultSpec(seed=5, drop_rate=0.3, max_retries=2),
        obs=api.ObsSpec(taps=ALL_TAPS))
    data = spec.data.build(card)
    got = api.fit(spec, device=card, data=data)
    want = api.fit(spec, device="cpu", data=data)
    assert got.history.bytes_transmitted == want.history.bytes_transmitted
    for name in ALL_TAPS:
        a, b = got.metrics[name], want.metrics[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name in ("accepts", "budget_rejects", "fault_retries"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), 1e-30), name
    assert got.metrics["eta"].tolist() == got.history.eta[1:]


@pytest.mark.parametrize("source,kw", [
    ("cosine", dict(noise=0.1, drift_option="freq", drift_start=1.0, drift_end=1.4)),
    ("friedman1", dict(noise=0.37)),
])
def test_chunk_source_on_card_equals_cpu(card, source, kw):
    from repro_torch.stream import ChunkSource

    on_card = ChunkSource(source, 64, 50, seed=4, device=card, **kw)
    on_cpu = ChunkSource(source, 64, 50, seed=4, device="cpu", **kw)
    for t in range(0, 50, 7):
        (xg, yg), (xc, yc) = on_card(t), on_cpu(t)
        assert torch.equal(xg.cpu(), xc) and torch.equal(yg.cpu(), yc), t


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_replace_col_on_card_matches_cpu(card, dtype, tol):
    from repro_torch.core import covstate

    gen = torch.Generator().manual_seed(4)
    r = torch.randn((100, 512), generator=gen, dtype=dtype)
    r[:, 9] = 0.0
    r[:, 70:80] = 0.0
    c = torch.randn((100, 64), generator=gen, dtype=dtype)
    # one arrival over a filled and an empty slot, and a chunk of 64 (the
    # stream's commit) over filled and empty slots
    for j, n in ((3, 1), (9, 1), (40, 64)):
        want = covstate.replace_cols(covstate.build(r), j, c[:, :n])
        got = covstate.replace_cols(covstate.build(r.to(card)), j, c[:, :n].to(card))
        for name in ("a0", "m_inv", "s", "eta_tilde", "r_sub"):
            g, w = getattr(got, name).cpu(), getattr(want, name)
            assert (g - w).abs().max() <= tol * w.abs().max(), (name, n)


def _short_stream(engine="fused", use_kernel=True, taps=("eta", "accepts")):
    return api.StreamSpec(
        experiment=api.ExperimentSpec(
            data=api.DataSpec(source="cosine"),
            solver=api.SolverSpec(engine=engine, use_kernel=use_kernel),
            obs=api.ObsSpec(taps=taps)),
        window=256, chunk=32, resweep_every=128, total_instances=512,
        drift_option="freq", drift_start=1.0, drift_end=1.4)


@pytest.mark.parametrize("engine", ["fused", "incremental"])
def test_short_stream_on_card_matches_cpu(card, engine):
    """The stream loop on the card (draws, ingest, resweeps, ledger) in
    float64 on the plain products: records within 1e-8 of the CPU's (the
    two devices' matrix products round apart in the last bits), bytes
    equal.  In float32 the live weights' Sherman–Morrison updates carry
    the card's and the CPU's rounding apart, so the kernel path's stream
    is held in chip_smoke phase 8e instead."""
    dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        spec = _short_stream(engine, use_kernel=False)
        got = api.stream_fit(spec, device=card)
        want = api.stream_fit(spec, device="cpu")
    finally:
        torch.set_default_dtype(dt)
    assert [r["bytes"] for r in got.records] == [r["bytes"] for r in want.records]
    for a, b in zip(got.records, want.records):
        for key in ("train_mse", "preq_mse", "eta"):
            assert abs(a[key] - b[key]) <= 1e-8 * abs(b[key]), key
    assert got.metrics["eta"].tolist() == [e for r in got.records for e in r["etas"]]


def _stream_gaps(got, want):
    """The largest relative difference of two stream runs' record floats,
    and of their s taps (normwise each record)."""
    rec = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(got, want)
              for k in ("train_mse", "preq_mse", "eta"))
    s = max(float(np.abs(a["taps"]["s"] - b["taps"]["s"]).max()
                  / np.abs(b["taps"]["s"]).max()) for a, b in zip(got, want))
    return {"records": rec, "s": s}


@pytest.mark.parametrize("engine,other", [("fused", "incremental"),
                                          ("incremental", "fused")])
def test_short_stream_f32_kernels_within_the_cpu_engines_spread(card, engine, other):
    """The stream on the kernels in float32: accept flags and bytes equal
    to the CPU's, the records and the s tap within 4x the CPU's own spread
    between its two engines (the same sweeps, their sums in two orders:
    the raw cosine chunks' ridge Gram has cond ~5e5, so float32 records
    move by ~1e-3 with any change of a sum's order; chip_smoke phase 8e's
    STREAM_F32_FACTOR)."""
    taps = ("eta", "accepts", "s")
    got = api.stream_fit(_short_stream(engine, taps=taps), device=card)
    want = api.stream_fit(_short_stream(engine, taps=taps), device="cpu")
    witness = api.stream_fit(_short_stream(other, taps=taps), device="cpu")
    assert [r["bytes"] for r in got.records] == [r["bytes"] for r in want.records]
    np.testing.assert_array_equal(got.metrics["accepts"], want.metrics["accepts"])
    gaps, spread = _stream_gaps(got.records, want.records), _stream_gaps(
        witness.records, want.records)
    for k in gaps:
        assert gaps[k] <= 4.0 * spread[k], (k, gaps[k], spread[k])


def test_stream_fit_computes_in_full_fp32_under_tf32(card):
    """A caller's TF32 setting leaves stream_fit's float32 products in full
    fp32 (the same bits as with TF32 off) and is given back afterwards."""
    saved = torch.get_float32_matmul_precision()
    spec = _short_stream()
    try:
        torch.set_float32_matmul_precision("high")
        with_tf32 = api.stream_fit(spec, device=card)
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cuda.matmul.allow_tf32
        torch.set_float32_matmul_precision("highest")
        without = api.stream_fit(spec, device=card)
    finally:
        torch.set_float32_matmul_precision(saved)
    assert len(with_tf32.records) == len(without.records)
    for a, b in zip(with_tf32.records, without.records):
        assert {k: v for k, v in a.items() if k != "taps"} == \
            {k: v for k, v in b.items() if k != "taps"}
    assert torch.equal(with_tf32.weights, without.weights)


def test_stream_checkpoint_saved_on_card_restores_on_cpu(card, tmp_path):
    from repro_torch.stream import build_ingestor, restore_stream, save_stream

    spec = dataclasses.replace(_short_stream(), checkpoint_every=256)
    got = api.stream_fit(spec, device=card, checkpoint_dir=str(tmp_path))
    save_stream(str(tmp_path / "end"), got.state)
    back, step = restore_stream(str(tmp_path / "end"),
                                like=build_ingestor(spec, device="cpu").init_state())
    assert step == 512 and back.ledger.spent == got.state.ledger.spent
    assert back.xcols.device.type == "cpu"
    for name in ("xcols", "y", "f", "weights", "key", "preq_sse"):
        assert torch.equal(getattr(back, name), getattr(got.state, name).cpu()), name
    for name in back.cov._fields:
        assert torch.equal(getattr(back.cov, name),
                           getattr(got.state.cov, name).cpu()), name


@pytest.mark.parametrize("engine", ["incremental", "fused"])
def test_checked_fit_on_card_equals_unchecked(card, engine):
    """checks="raise" on the card: fit and a 4-trial batch_fit give the off
    mode's bits (the check sites only read), and launch the same kernels."""
    spec = api.ExperimentSpec(data=api.DataSpec(n_train=1000, n_test=500),
                              solver=api.SolverSpec(engine=engine, n_sweeps=3,
                                                    use_kernel=True),
                              transport=api.TransportSpec(codec="int8_affine"))
    on = dataclasses.replace(spec, backend=api.BackendSpec(checks="raise"))
    data = spec.data.build(card)
    runs = []
    for s in (spec, on):
        _build.reset_launches()
        runs.append((api.fit(s, device=card, data=data), dict(_build.LAUNCHES)))
    (off, l_off), (chk, l_on) = runs
    assert l_on == l_off
    for key in ("train_mse", "test_mse", "eta", "bytes_transmitted"):
        assert getattr(chk.history, key) == getattr(off.history, key), key
    assert torch.equal(chk.weights, off.weights) and torch.equal(chk.f, off.f)
    b_off, b_on = api.batch_fit(spec, 4, device=card), api.batch_fit(on, 4, device=card)
    for key in ("train_mse", "test_mse", "eta", "bytes_transmitted"):
        assert np.array_equal(b_on.stack(key), b_off.stack(key)), key


def test_nan_codec_raises_located_error_on_card(card):
    from repro_torch import transport
    from repro_torch.analysis import CheckError
    from repro_torch.transport import codecs

    @dataclasses.dataclass(frozen=True)
    class NaNCodec(codecs.Codec):
        def decode(self, payload):
            return payload * float("nan")

        def nbytes(self, n_elems):
            return float(8 * n_elems)

        def is_identity_for(self, dtype):
            return False

    transport.register_codec("nan_on_card")(lambda: NaNCodec(name="nan_on_card"))
    try:
        spec = api.ExperimentSpec(
            solver=api.SolverSpec(engine="fused", use_kernel=True, n_sweeps=2),
            transport=api.TransportSpec(codec="nan_on_card"),
            backend=api.BackendSpec(checks="raise"))
        with pytest.raises(CheckError, match="codec 'nan_on_card' delivered a "
                           "non-finite payload over topology 'full'$"):
            api.fit(spec, device=card)
        with pytest.raises(CheckError, match=r"\(trial 0 of 3\)$"):
            api.batch_fit(spec, 3, device=card)
    finally:
        codecs.CODECS.pop("nan_on_card", None)


# ------------------------------------------------------------ LM training


B9_BWD_CASES = [
    (2, 150, 150, 15, 5, 64, True, 0),      # G = 3, ragged tiles
    (1, 77, 77, 3, 1, 80, True, 16),        # the smollm smoke heads, window
    (2, 40, 93, 4, 2, 64, False, 0),        # non-causal, ragged Skv
    (1, 96, 96, 8, 1, 128, True, 32),       # G = 8, window inside a tile
    (1, 200, 200, 2, 2, 128, True, 0),      # G = 1
    (1, 1, 5, 4, 4, 64, False, 0),          # one query row against 5 keys
    (1, 300, 300, 4, 1, 128, True, 130),    # a window across 128-key tiles
    (1, 1024, 1024, 15, 5, 64, True, 0),    # smollm's heads at S = 1024
    (1, 1500, 1500, 16, 16, 64, False, 0),  # whisper-medium's encoder
    (1, 448, 1500, 16, 16, 64, False, 0),   # its cross-attention: 28 keys in the last tile
    (1, 2048, 2048, 28, 4, 128, True, 0),   # qwen2-vl-7b's G = 7 at dh 128
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,dh,causal,window", B9_BWD_CASES)
def test_flash_attention_train_forward_and_backward(card, dtype, b, sq, skv, hq, hkv, dh,
                                                    causal, window):
    """B9's training forward gives the serving forward's bits and the rows'
    log-sum-exp (1e-5 of the plain version's, relative); its backward the
    same bits twice and, against the plain closed form on the same inputs
    (q, k, v, o, dO, L), fp32 gradients within 1e-4 normwise, bf16 ones
    within twice the plain version's own bf16 rounding of the fp32 gradient.
    bf16 at dh 64 and 128 runs the tensor-core backward (its counter moves),
    fp32 and bf16 at dh 80 the FMA one."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    q, k, v, do = _lm(7, (b, sq, hq, dh), (b, skv, hkv, dh), (b, skv, hkv, dh),
                      (b, sq, hq, dh), dtype=dtype, device=card)
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    out2, lse = fa_ops.flash_attention_lse(q, k, v, causal=causal, window=window)
    assert torch.equal(out, out2)
    _, lse_ref = fa_ref.attention_lse_ref(q, k, v, causal=causal, window=window)
    _close(lse, lse_ref, 1e-5, "lse")
    _build.reset_launches()
    got = fa_ops.flash_attention_bwd(q, k, v, out, do, lse, causal=causal, window=window)
    again = fa_ops.flash_attention_bwd(q, k, v, out, do, lse, causal=causal, window=window)
    launched = _build.LAUNCHES["flash_attention_bwd"]
    launched_tc = _build.LAUNCHES["flash_attention_bwd_tc"]
    plain = fa_ref.attention_bwd_ref(q, k, v, out, do, lse, causal=causal, window=window)
    want32 = fa_ref.attention_bwd_ref(q.float(), k.float(), v.float(), out.float(),
                                      do.float(), lse, causal=causal, window=window)
    for name, g, g2, p, w in zip(("dq", "dk", "dv"), got, again, plain, want32):
        assert g.dtype == dtype and torch.equal(g, g2), name
        if dtype == torch.float32:
            _close(g, p, 1e-4, name)
        else:
            # the plain bf16 version's own distance to the fp32 gradient
            err, own = _normwise(g, w), _normwise(p, w)
            assert err <= 2 * own, f"{name}: {err:.3e} > 2 x {own:.3e}"
    assert launched == 2
    assert launched_tc == (2 if fa_ops.bwd_route(dtype, dh) == "tc" else 0)
    assert (fa_ops.bwd_route(dtype, dh) == "tc") == (dtype == torch.bfloat16 and dh != 80)


@pytest.mark.parametrize("b,s,h,dh,decay", [(2, 333, 4, 64, "moderate"), (1, 77, 8, 32, "strong"),
                                             (1, 1, 2, 64, "weak"), (2, 9, 3, 32, "moderate"),
                                             (1, 8, 2, 64, "strong"), (1, 200, 2, 64, "weak"),
                                             (2, 75, 3, 64, "zeros"), (1, 21, 2, 32, "zeros")])
def test_wkv_backward_matches_plain(card, b, s, h, dh, decay):
    """B11's backward against its plain closed form on the same inputs
    (fp32, 1e-4 normwise), the same bits twice, and wkv_train's gradients
    on the card against the CPU's (the plain version) at 1e-4; its final
    state is wkv_chunked's and carries no gradient.  "zeros": strong decay
    with w exactly 0 at every 5th token and 3rd row, S not a multiple of
    the backward's 16-token chunk."""
    from repro_torch.kernels.wkv.ops import wkv_bwd, wkv_chunked, wkv_train
    from repro_torch.kernels.wkv.ref import wkv_bwd_ref

    r, k, v, z, g = _lm(11, *[(b, s, h, dh)] * 5, dtype=torch.float32, device=card)
    shift = {"strong": 1.0, "moderate": -1.0, "weak": -6.0, "zeros": 1.0}[decay]
    w = torch.exp(-torch.exp(z + shift))
    if decay == "zeros":
        w[:, ::5, :, ::3] = 0.0
    u = 0.1 * _lm(12, (h, dh), dtype=torch.float32, device=card)[0]
    _build.reset_launches()
    got, again = wkv_bwd(r, k, v, w, u, g), wkv_bwd(r, k, v, w, u, g)
    launched = _build.LAUNCHES["wkv_bwd"]
    for name, a, a2, p in zip(("dr", "dk", "dv", "dw", "du"), got, again,
                              wkv_bwd_ref(r, k, v, w, u, g)):
        assert torch.equal(a, a2), name
        _close(a, p, 1e-4, name)
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
    out, state = wkv_train(*leaves)
    assert not state.requires_grad
    assert torch.equal(state, wkv_chunked(r, k, v, w, u)[1])
    card_grads = torch.autograd.grad(out, leaves, g)
    cpu = [t.cpu().requires_grad_(True) for t in (r, k, v, w, u)]
    cpu_grads = torch.autograd.grad(wkv_train(*cpu)[0], cpu, g.cpu())
    for name, a, c in zip("rkvwu", card_grads, cpu_grads):
        _close(a.cpu(), c, 1e-4, f"d{name}")
    assert launched == 2


def test_wkv_backward_geometry_matches_library(card):
    """The reverse pass's shared memory as the library reports it equals
    the pure-Python wkv_bwd_smem_bytes, at both head dims."""
    from repro_torch.kernels.wkv.ops import wkv_bwd_smem_bytes

    for dh in HEAD_DIMS:
        assert _build.query("wkv", "repro_wkv_bwd_smem", dh) == wkv_bwd_smem_bytes(dh)


@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-1.6b"])
def test_loss_and_gradients_on_card_match_cpu(card, arch):
    """The smoke config's Model.loss and every parameter's gradient on the
    card (B9 / B11 and their backward kernels) against the CPU from the same
    parameters and batch: fp32, 1e-4 normwise, every card gradient finite
    and not all zero; then one train_step each way (loss, grad norm, lr)."""
    from repro_torch.configs import RunConfig
    from repro_torch.data.lm import lm_batches
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.clip import tree_leaves, tree_map
    from repro_torch.train import TrainState, make_train_step

    model = build_model(get_config(arch, smoke=True))
    params = model.init(seed=0, device="cpu")
    batch = next(lm_batches(model, seq=48, batch=2, device="cpu"))
    grads, losses, launched = {}, {}, {}
    for where, dev in (("card", card), ("cpu", torch.device("cpu"))):
        tree = tree_map(lambda t: t.to(dev).requires_grad_(True), params)
        leaves = list(tree_leaves(tree))
        _build.reset_launches()
        loss, _ = model.loss(tree, {k: t.to(dev) for k, t in batch.items()})
        grads[where] = [x.cpu() for x in torch.autograd.grad(loss, leaves)]
        losses[where] = float(loss.detach())
        launched[where] = {k: n for k, n in _build.LAUNCHES.items() if n}
    assert abs(losses["card"] - losses["cpu"]) <= 1e-5 * abs(losses["cpu"])
    for i, (g, c) in enumerate(zip(grads["card"], grads["cpu"])):
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any()), i
        _close(g, c, 1e-4, f"gradient leaf {i}")
    run = RunConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    step = make_train_step(model, run)
    mets = {}
    for where, dev in (("card", card), ("cpu", torch.device("cpu"))):
        p = _to(params, dev)
        state = TrainState(p, adamw_init(p, AdamWConfig(moment_dtype=model.cfg.moment_dtype)),
                           torch.zeros((), dtype=torch.int32, device=dev))
        _, met = step(state, {k: t.to(dev) for k, t in batch.items()})
        mets[where] = {k: float(x) for k, x in met.items()}
    for key in ("loss", "grad_norm", "lr"):
        assert abs(mets["card"][key] - mets["cpu"][key]) <= 1e-4 * abs(mets["cpu"][key]), key
    n = model.cfg.n_layers
    assert launched["card"] == ({"flash_attention": n, "flash_attention_bwd": n}
                                if arch.startswith("smollm") else {"wkv": n, "wkv_bwd": n})


TRAIN_FAMILY_SMOKES = {"phi3.5-moe-42b-a6.6b": {}, "jamba-v0.1-52b": {},
                      "whisper-medium": {}, "qwen2-vl-7b": {"microbatch": 2}}


@pytest.mark.parametrize("arch", list(TRAIN_FAMILY_SMOKES))
def test_family_smoke_trains_on_card_like_cpu(card, arch):
    """The moe, hybrid, encdec and vlm smoke configs (fp32; qwen2-vl in 2
    microbatches) train 2 steps on the card and on the CPU from the same
    state and batches: each step's loss, grad norm and lr within 1e-4, and
    the card's launches B9's forward and backward once for each attention
    call of a microbatch (the smoke configs run without remat)."""
    from repro_torch.configs import RunConfig
    from repro_torch.data.lm import lm_batches
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = dataclasses.replace(get_config(arch, smoke=True), **TRAIN_FAMILY_SMOKES[arch])
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    seq = 48 + cfg.n_vision_tokens
    step = make_train_step(model, RunConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10))
    mets = {}
    for where, dev in (("card", card), ("cpu", torch.device("cpu"))):
        p = _to(params, dev)
        state = TrainState(p, adamw_init(p, AdamWConfig(moment_dtype=cfg.moment_dtype)),
                           torch.zeros((), dtype=torch.int32, device=dev))
        batches = lm_batches(model, seq=seq, batch=4, device=dev)
        _build.reset_launches()
        mets[where] = []
        for _ in range(2):
            state, met = step(state, next(batches))
            mets[where].append({k: float(x) for k, x in met.items()})
        if where == "card":
            launched = {k: n for k, n in _build.LAUNCHES.items() if n}
    for got, want in zip(mets["card"], mets["cpu"]):
        for key in ("loss", "grad_norm", "lr"):
            assert abs(got[key] - want[key]) <= 1e-4 * abs(want[key]), (key, got, want)
    calls = (cfg.n_enc_layers + 2 * cfg.n_layers if cfg.family == "encdec"
             else cfg.layer_kinds().count("attn")) * max(1, cfg.microbatch) * 2
    assert launched == {"flash_attention": calls, "flash_attention_bwd": calls}


def test_training_entry_points_run_on_card(card, tmp_path):
    """init_state and launch.train default to the card: three smoke steps
    there, a checkpoint written and restored."""
    from repro_torch.configs import RunConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.train import init_state

    state = init_state(build_model(get_config("smollm-360m", smoke=True)), 0, RunConfig())
    assert state.step.is_cuda and state.params["embed"]["tok"].is_cuda
    args = ["--arch", "rwkv6-1.6b", "--smoke", "--steps", "3", "--seq", "32", "--batch", "2",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    assert launch_train.main(args) == 0
    assert launch_train.main(args[:4] + ["1"] + args[5:]) == 0


# ------------------------------------------- the shard_map backend's ranks


@pytest.mark.cuda
def test_two_ranks_on_one_card_launch_b1_and_b3(card):
    """Two ranks of a gloo group share cuda:0 (the shard_map backend's
    layout on one card): each launches B1 and B3 once, counted by its own
    _build.LAUNCHES, each result within 1e-5 of the plain version, and
    the gather of their CUDA rows (staged through the host) returns each
    rank's row bit for bit, on the card."""
    import torch_distributed_helpers as helpers
    from repro_torch.core import distributed

    outs = distributed.launch(helpers.card_kernels, 2, (5, 2000), device="cuda",
                              build_kernels=True)
    for r, out in enumerate(outs):
        assert out["rank"] == r
        assert out["launches"] == {"gram": 1, "row_gram": 1}
        assert out["gram_err"] <= 1e-5 and out["row_gram_err"] <= 1e-5
        assert out["device"].startswith("cuda") and out["staged"] > 0
        for k in range(2):
            assert np.array_equal(out["gathered"][k], outs[k]["row"])
