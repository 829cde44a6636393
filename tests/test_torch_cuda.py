"""repro_torch on the card: the CUDA kernels against their plain versions,
and `api.fit` and `api.batch_fit` on the card against the same runs on the
CPU.

Every test here is marked `cuda` and skips without a CUDA device: the
kernels have no CPU mode.  The file imports neither jax nor repro, so it
also runs where only PyTorch is installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are normwise (max |kernel - plain| <= tol * max |plain|): 1e-5
for the Gram products, 1e-4 for the sweep kernels, whose closed-form
epilogue divides by SMW pivots (both sides fp32).  The batched kernels
must give trial b exactly the single-trial kernel's bits (torch.equal).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.kernels import _build
from repro_torch.kernels.gram import ops as gram_ops
from repro_torch.kernels.gram import ref as gram_ref
from repro_torch.kernels.sweep import ops as sweep_ops
from repro_torch.kernels.sweep import ref as sweep_ref

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


def _close(got, want, tol, what):
    err = float((got.double() - want.double()).abs().max())
    scale = max(float(want.double().abs().max()), 1e-30)
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


@pytest.mark.parametrize("d,n", [(1, 7), (5, 600), (65, 3000), (100, 20000)])
def test_kernels_match_plain(card, d, n):
    sc = _scene(d, n, seed=d, device=card)
    i = d // 2
    before = dict(_build.LAUNCHES)
    got = gram_ops.gram(sc["r"])
    _close(got, gram_ref.gram_ref(sc["r"]), 1e-5, "gram")
    assert torch.equal(got, got.T)
    _close(gram_ops.row_gram(sc["v"], sc["r"]),
           gram_ref.row_gram_ref(sc["v"], sc["r"]), 1e-5, "row_gram")
    args = (sc["r"], sc["m_inv"], sc["s"], sc["eta"], i, sc["steps"])
    for g, w in zip(sweep_ops.probe_sweep(*args), sweep_ref.probe_sweep_ref(*args)):
        _close(g, w, 1e-4, "probe")
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
    assert {k: _build.LAUNCHES[k] - before[k] for k in before} == {
        "gram": 1, "row_gram": 1, "probe_sweep": 1, "commit_sweep": 2,
        "gram_batched": 0, "row_gram_batched": 0, "probe_sweep_batched": 0,
        "commit_sweep_batched": 0}


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
@pytest.mark.parametrize("d,n", [(1, 7), (5, 600), (65, 3000), (100, 20000)])
def test_batched_kernels_match_plain_and_single(card, d, n, b):
    """Each batched kernel against its batched plain version, and slice t
    against the single-trial kernel on trial t, bit for bit; a commit batch
    with mixed accept and reject keeps the rejected trials bitwise."""
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
    for g, w in zip(probe, sweep_ref.probe_sweep_batched_ref(*args)):
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
