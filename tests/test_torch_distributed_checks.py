"""The shard_map backend under the sanitizer rail (BackendSpec(checks=
"raise")), against the JAX package's own checked shard_map runs (5 host
devices, float64):

  * the checked incremental body on the parity cell of
    test_torch_distributed.py (Friedman-1, D = 5, N = 200 / 100, 3
    sweeps) equals the reference's checked run at 1e-10, bytes equal
    (ROADMAP C4: the reference's checked shard_map run works; its test
    fails later, in a local batch_fit), and the port's off run bit for
    bit, on every rank;
  * a NaN-decoding codec (cosine data, 2 agents, launched by fit from this
    process) raises the port's CheckError at the caller, with the JAX
    package's site message.
"""
import numpy as np
import pytest
import torch

import torch_distributed_helpers as helpers
from repro_torch import api as tapi
from repro_torch.analysis.sanitize import CheckError
from torch_distributed_helpers import shard_map_spec as _spec

CASES = {"checked": dict(_spec(), backend={"name": "shard_map",
                                          "checks": "raise"})}
NAN = {"data": {"source": "cosine", "n_attrs": 2, "n_train": 40, "n_test": 20},
       "solver": {"n_sweeps": 1}, "transport": {"codec": "nan_injector"},
       "backend": {"name": "shard_map", "checks": "raise"}}


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """One intra-op thread for this module's process (each rank runs one
    of its own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(single_thread):
    """(every rank's fit_cases output, the reference's records)."""
    ref = helpers.Reference({**CASES, "nan": NAN})
    ranks = helpers.launch_cases({**CASES, "off": _spec()})
    return ranks, ref.get()


def test_checked_run_matches_jax_checked_run_f64(runs):
    ranks, ref = runs
    helpers.assert_matches(ranks[0]["fits"]["checked"], ref["checked"],
                           "checked")


def test_checked_run_gives_the_off_runs_bits(runs):
    for r in runs[0]:
        fits = r["fits"]
        helpers.assert_same_run(fits["checked"], fits["off"])
        assert np.array_equal(fits["checked"]["rank_a0"], fits["off"]["rank_a0"])


def test_nan_codec_raises_check_error_at_the_caller(runs):
    helpers.register_nan_codec()
    dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with pytest.raises(CheckError) as err:
            tapi.fit(tapi.spec_from_dict(NAN), device="cpu")
    finally:
        torch.set_default_dtype(dt)
    want = runs[1]["nan"]
    assert want["error"] == "JaxRuntimeError" and "non-finite" in want["message"]
    assert err.value.site == str(err.value) == want["message"]
    assert err.value.trial is None
