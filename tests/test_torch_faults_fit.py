"""repro_torch.api.fit against repro.api.fit under every fault kind: drops
with retries, corruption, stragglers, crash and rejoin, and all of them at
once (the JAX package's own _FAULTS of tests/test_faults.py), on the
incremental and fused engines, without a budget and under a byte budget
with each policy (truncate, greedy_eta) — from the spec in float64:
histories at 1e-10, weights at 1e-9, the byte ledgers exactly equal (the
JAX package's ledger arithmetic: alive-only gathers, attempts x price per
broadcast).  One float32 run at the fp32 bound.  (Kept apart from
test_torch_faults.py so that the two files run on different workers.)
"""
import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro_torch import api as tapi

KINDS = {
    "drop": dict(seed=5, drop_rate=0.4, max_retries=2),
    "corrupt": dict(seed=5, corrupt_rate=0.5, corrupt_bits=12),
    "straggle": dict(seed=5, straggle_rate=0.3),
    "crash": dict(crash=[[1, 1, 3], [3, 0, -1]]),
    "all": dict(seed=5, drop_rate=0.3, corrupt_rate=0.2, corrupt_bits=4,
                straggle_rate=0.1, max_retries=2, crash=[[1, 1, 3]]),
}
# a clean sweep of this cell costs 9600 bytes: the budgets run out mid-run
BUDGETS = {"none": None, "truncate": ("truncate", 28000.0),
           "greedy_eta": ("greedy_eta", 28000.0)}
F32_TOL = 1e-5


def _dict(kind, engine, budget):
    d = {"data": {"n_train": 150, "n_test": 150, "seed": 7},
         "agent": {"family": "polynomial", "options": [["degree", 3]]},
         "solver": {"n_sweeps": 4, "eps": 0.0, "engine": engine}, "seed": 1,
         "faults": KINDS[kind]}
    if BUDGETS[budget] is not None:
        policy, cap = BUDGETS[budget]
        d["transport"] = {"byte_budget": cap, "policy": policy}
    return d


def _both(d, x64):
    dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64 if x64 else torch.float32)
    try:
        tres = tapi.fit(tapi.spec_from_dict(d), device="cpu")
    finally:
        torch.set_default_dtype(dt)
    japi.clear_dataset_cache()
    try:
        with jax.enable_x64(x64):
            jres = japi.fit(japi.spec_from_dict(d))
    finally:
        japi.clear_dataset_cache()
    return tres, jres


@pytest.mark.parametrize("budget", list(BUDGETS))
@pytest.mark.parametrize("engine", ["incremental", "fused"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_fault_fit_matches_jax_f64(kind, engine, budget):
    tres, jres = _both(_dict(kind, engine, budget), True)
    for key in ("train_mse", "test_mse", "eta"):
        np.testing.assert_allclose(getattr(tres.history, key),
                                   getattr(jres.history, key), rtol=1e-10,
                                   err_msg=key)
    assert tres.history.bytes_transmitted == jres.history.bytes_transmitted
    np.testing.assert_allclose(tres.weights.numpy(), np.asarray(jres.weights),
                               rtol=1e-9, atol=1e-12)
    if kind == "crash":                  # agent 3 never rejoins
        assert tres.weights[3].item() == 0.0 == float(np.asarray(jres.weights)[3])


def test_fault_fit_matches_jax_f32():
    """float32, every fault at once: the trace draws float32 uniforms on
    both sides (the same draws), so bytes are equal and the records within
    the fp32 bound."""
    tres, jres = _both(_dict("all", "fused", "none"), False)
    assert tres.f.dtype == torch.float32
    for key in ("train_mse", "test_mse", "eta"):
        np.testing.assert_allclose(getattr(tres.history, key),
                                   getattr(jres.history, key), rtol=F32_TOL,
                                   err_msg=key)
    assert tres.history.bytes_transmitted == jres.history.bytes_transmitted
