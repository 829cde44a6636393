"""repro_torch.api.fit against repro.api.fit on every transport: each
topology (full, ring, star, random_graph p=0.8 seed=3) x codec (exact_f64,
exact_f32, exact_bf16, int8_affine, topk_sparse k=64) x engine (dense,
incremental, fused), from the spec in float64: histories at 1e-10, the byte
ledgers exactly equal.  (Kept apart from test_torch_transport.py so that
the two files run on different workers.)
"""
import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro_torch import api as tapi

TOPOLOGIES = [("full", []), ("ring", []), ("star", []),
              ("random_graph", [["p", 0.8], ["seed", 3]])]
CODECS = [("exact_f64", []), ("exact_f32", []), ("exact_bf16", []),
          ("int8_affine", []), ("topk_sparse", [["k", 64]])]


@pytest.mark.parametrize("engine", ["dense", "incremental", "fused"])
@pytest.mark.parametrize("codec", CODECS, ids=lambda c: c[0])
@pytest.mark.parametrize("topo", TOPOLOGIES, ids=lambda t: t[0])
def test_fit_matches_jax_on_every_transport_f64(topo, codec, engine):
    d = {"data": {"n_train": 200, "n_test": 100, "seed": 3},
         "solver": {"n_sweeps": 2, "engine": engine, "eps": 0.0}, "seed": 2,
         "transport": {"topology": topo[0], "topology_options": topo[1],
                       "codec": codec[0], "codec_options": codec[1]}}
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
    for key in ("train_mse", "test_mse", "eta"):
        np.testing.assert_allclose(getattr(tres.history, key),
                                   getattr(jres.history, key), rtol=1e-10,
                                   err_msg=key)
    assert tres.history.bytes_transmitted == jres.history.bytes_transmitted
    per = tapi.comm_floats_per_sweep(tapi.spec_from_dict(d).solver, 5, 200)
    if codec[0] == "exact_f64" and topo[0] == "full":
        assert tres.history.bytes_transmitted[1:] == [per * 8.0] * 2
