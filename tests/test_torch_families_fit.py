"""repro_torch.api with the rff and mlp families against repro.api, from
the spec in float64 (torch's default dtype float64, jax.enable_x64):

  * both families x engine {dense, incremental, fused} x alpha {1, 20}
    at 1e-10 (mlp: the Adam steps take XLA's roundings but for its tanh,
    so the gap is ~1e-15; the bound that the JAX package's own one-ulp
    spread sets for a single mlp fit is in test_torch_families.py); bytes
    equal, and mlp's params keep the JAX package's dtypes (float64
    weights, float32 biases);
  * fig1_overtraining's mlp cell, cut down, through batch_fit with icoa and
    residual_refitting against repro.api.batch_fit, trial by trial.
(Kept apart from test_torch_families.py so that the two files run on
different workers.)
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro_torch import api as tapi


# --------------------------------------------------------- from the spec


def _run_both(d):
    dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        tres = tapi.fit(tapi.spec_from_dict(d), device="cpu")
    finally:
        torch.set_default_dtype(dt)
    japi.clear_dataset_cache()
    try:
        with jax.enable_x64(True):
            jres = japi.fit(japi.spec_from_dict(d))
    finally:
        japi.clear_dataset_cache()
    return tres, jres


@pytest.mark.parametrize("alpha", [1.0, 20.0])
@pytest.mark.parametrize("engine", ["dense", "incremental", "fused"])
@pytest.mark.parametrize("family", ["rff", "mlp"])
def test_family_fit_from_spec_matches_jax(family, engine, alpha):
    opts = [["hidden", 8], ["fit_steps", 20]] if family == "mlp" else []
    d = {"data": {"n_train": 200, "n_test": 100, "seed": 3},
         "agent": {"family": family, "options": opts},
         "solver": {"n_sweeps": 2, "engine": engine, "alpha": alpha}, "seed": 2}
    tres, jres = _run_both(d)
    assert tres.history.bytes_transmitted == jres.history.bytes_transmitted
    for key in ("train_mse", "test_mse", "eta"):
        np.testing.assert_allclose(getattr(tres.history, key),
                                   getattr(jres.history, key), rtol=1e-10,
                                   err_msg=key)
    if family == "rff":
        return
    assert {k: v.dtype for k, v in tres.params.items()} == {
        "w1": torch.float64, "b1": torch.float32, "w2": torch.float64,
        "b2": torch.float32, "w3": torch.float64, "b3": torch.float32}


def test_fig1_mlp_cell_batch_fit_matches_jax():
    """fig1_overtraining's mlp cell, cut down (N 120, hidden 6, 10 steps,
    2 trials x 2 sweeps): icoa and residual_refitting through batch_fit,
    trial by trial against repro.api.batch_fit in float64 at 1e-10."""
    base = {"data": {"n_train": 120, "n_test": 120, "seed": 0},
            "agent": {"family": "mlp", "options": [["hidden", 6], ["fit_steps", 10]]},
            "solver": {"n_sweeps": 2}}
    for name in ("icoa", "residual_refitting"):
        d = json.loads(json.dumps(base))
        d["solver"]["name"] = name
        dt = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)
        try:
            trs = tapi.batch_fit(tapi.spec_from_dict(d), 2, device="cpu")
        finally:
            torch.set_default_dtype(dt)
        japi.clear_dataset_cache()
        try:
            with jax.enable_x64(True):
                jrs = japi.batch_fit(japi.spec_from_dict(d), 2)
        finally:
            japi.clear_dataset_cache()
        for t in range(2):
            got, want = trs[t].history, jrs.results[t].history
            assert got.bytes_transmitted == want.bytes_transmitted
            for key in ("train_mse", "test_mse", "eta"):
                np.testing.assert_allclose(getattr(got, key), getattr(want, key),
                                           rtol=1e-10, err_msg=f"{name} {key}")
            assert trs[t].params["b2"].dtype == torch.float32
