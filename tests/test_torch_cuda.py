"""repro_torch on the card: the CUDA kernels against their plain versions,
and `api.fit` on the card against the same fit on the CPU.

Every test here is marked `cuda` and skips without a CUDA device: the
kernels have no CPU mode.  The file imports neither jax nor repro, so it
also runs where only PyTorch is installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are normwise (max |kernel - plain| <= tol * max |plain|): 1e-5
for the Gram products, 1e-4 for the sweep kernels, whose closed-form
epilogue divides by SMW pivots (both sides fp32).
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
        "gram": 1, "row_gram": 1, "probe_sweep": 1, "commit_sweep": 2}


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
