"""The shard_map backend through the API: the baselines, the spec rules
and batch_fit, and the agent group's collectives (the checked runs:
test_torch_distributed_checks.py).

Against the JAX package (repro.api.fit on 5 host devices, float64; the
parity cell of test_torch_distributed.py: Friedman-1, D = 5, N = 200 /
100): averaging, residual refitting whose ring codes the leave-me-out
sum with int8_affine on the ring topology, and icoa's incremental body at
alpha = 20, delta = 0 (the N/alpha subsample drawn inside the body from
the sweep's key, the exact local diagonal): histories and predictions at
1e-10, bytes equal; icoa's ranks agree bit for bit.

Without jax (in the launched ranks, or no ranks at all):

  * the masked psum delivers the owner's row bit for bit, and all_gather
    stacks the rows in rank order;
  * n_devices other than D is a SpecError, and so is shard_map with
    trial_devices; batch_fit on shard_map raises NotPortedError naming
    ROADMAP A11b unless compiled=False, whose trial t equals
    fit(trial_spec(spec, t));
  * no rank has loaded jax or the JAX package.
"""
import numpy as np
import pytest
import torch

import torch_distributed_helpers as helpers
from repro_torch import api as tapi
from torch_distributed_helpers import shard_map_spec as _spec

RING_INT8 = {"topology": "ring", "codec": "int8_affine"}
CASES = {
    "averaging": _spec(name="averaging"),
    "residual_refitting": dict(_spec(name="residual_refitting"),
                               transport=RING_INT8),
    "incremental-a20-d0": _spec(alpha=20.0),
}
BATCHES = {"icoa": dict(_spec(n_sweeps=2), data={"n_train": 60, "n_test": 30,
                                                  "seed": 3}),
           "averaging": dict(_spec(name="averaging"),
                             data={"n_train": 60, "n_test": 30, "seed": 3})}


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
    ref = helpers.Reference(CASES)
    ranks = helpers.launch_cases(CASES, BATCHES)
    return ranks, ref.get()


@pytest.mark.parametrize("name", list(CASES))
def test_api_runs_match_jax_f64(runs, name):
    ranks, ref = runs
    helpers.assert_matches(ranks[0]["fits"][name], ref[name], name)


def test_subsampled_body_agrees_across_ranks(runs):
    helpers.assert_ranks_agree(runs[0], "incremental-a20-d0")


def test_refit_ring_codes_the_sum(runs):
    """The ring's bytes are the codec's: 1,040 a cycle, 5 updates of 200
    one-byte values plus a scale and a zero point (8 bytes) each."""
    fits = runs[0][0]["fits"]
    assert fits["residual_refitting"]["bytes"] == [1040.0] * 3


@pytest.mark.parametrize("name", list(BATCHES))
def test_serial_batch_fit_trial_equals_its_fit(runs, name):
    got = runs[0][0]["batches"][name]
    helpers.assert_same_run(got["trials"][1], got["fit1"])
    assert got["trials"][0]["train_mse"] != got["trials"][1]["train_mse"]


def test_masked_psum_and_gather_order(runs):
    ranks, _ = runs
    rows = [r["row"] for r in ranks]
    for r in ranks:
        # the owner's row, bit for bit, on every rank
        assert np.array_equal(r["masked"], rows[r["owner"]])
        assert r["gathered"].shape == (5, 7)
        for k in range(5):
            assert np.array_equal(r["gathered"][k], rows[k])


def test_no_rank_imports_jax_or_repro(runs):
    for r in runs[0]:
        assert r["foreign"] == []


def test_spec_rules():
    d5 = _spec()
    ok = tapi.spec_from_dict(d5)
    ok.validate()                     # shard_map validates since A11a
    with pytest.raises(tapi.SpecError, match="trial_devices"):
        tapi.BackendSpec(name="shard_map", trial_devices=2).validate()
    bad = tapi.spec_from_dict(dict(d5, backend={"name": "shard_map",
                                                "n_devices": 4}))
    with pytest.raises(tapi.SpecError, match="one agent per device"):
        tapi.fit(bad, device="cpu")


@pytest.mark.parametrize("compiled", [None, True])
def test_compiled_batch_waits_for_a11b(compiled):
    spec = tapi.spec_from_dict(_spec())
    with pytest.raises(tapi.NotPortedError, match=r"ROADMAP A11b"):
        tapi.batch_fit(spec, 2, device="cpu", compiled=compiled)
