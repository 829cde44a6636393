"""The shard_map backend's ICOA sweep bodies against the JAX package's.

`repro_torch.api.fit(spec, device="cpu")` with `BackendSpec(name=
"shard_map")` runs one agent a rank of a gloo group
(repro_torch.core.distributed); `repro.api.fit` of the same spec runs the
JAX package's shard_map bodies on 5 host devices.  Friedman-1, its five
attributes one an agent, N = 200 train and 100 test, 3 sweeps, float64:

  * the incremental body at alpha = 1 with the obs taps ("eta",
    "accepts"), the dense body without row_broadcast at alpha = 1 and with
    it at alpha = 20 (the subsample and the exact diagonal): the histories
    and the predictions at 1e-10, the byte histories equal, the weights at
    1e-10, the taps equal (the incremental body at alpha > 1 and delta > 0:
    test_torch_distributed_minimax.py and _api.py);
  * the taps change nothing: the untapped run gives the tapped run's
    bits;
  * engine="fused" maps to the incremental body, as in the JAX package:
    its run equals the incremental run bit for bit;
  * the replicated algebra agrees across ranks: every rank's history,
    final weights and final A0 are the same bits.

The port's fits run in place on one launched group of five ranks
(torch_distributed_helpers.fit_cases), the reference's in one subprocess;
the two run side by side.
"""
import numpy as np
import pytest
import torch

import torch_distributed_helpers as helpers
from torch_distributed_helpers import shard_map_spec as _spec


TAPS = ["eta", "accepts"]
CASES = {
    "incremental": dict(_spec(), obs={"taps": TAPS}),
    "dense": _spec(engine="dense"),
    "dense-row_broadcast-a20": _spec(engine="dense", row_broadcast=True,
                                     alpha=20.0),
}
# the port only: the JAX package maps fused to the incremental body too
PORT_ONLY = {"incremental-untapped": _spec(),
             "fused": dict(_spec(engine="fused"), obs={"taps": TAPS})}


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
    ranks = helpers.launch_cases({**CASES, **PORT_ONLY})
    return ranks, ref.get()


@pytest.mark.parametrize("name", list(CASES))
def test_shard_map_body_matches_jax_f64(runs, name):
    ranks, ref = runs
    port = ranks[0]["fits"][name]
    helpers.assert_matches(port, ref[name], name)
    np.testing.assert_allclose(np.sum(port["weights"]), 1.0, rtol=1e-12)


def test_taps_match_jax_and_change_nothing(runs):
    ranks, ref = runs
    port, jref = ranks[0]["fits"]["incremental"], ref["incremental"]
    assert sorted(port["metrics"]) == sorted(jref["metrics"]) == sorted(TAPS)
    np.testing.assert_array_equal(port["metrics"]["accepts"],
                                  np.asarray(jref["metrics"]["accepts"]))
    assert port["metrics"]["accepts"].shape == (3, 5)
    np.testing.assert_allclose(port["metrics"]["eta"],
                               np.asarray(jref["metrics"]["eta"]), rtol=1e-10)
    # the eta tap is the history's record, bit for bit
    assert port["metrics"]["eta"].tolist() == port["eta"][1:]
    helpers.assert_same_run(ranks[0]["fits"]["incremental-untapped"], port)


def test_fused_engine_is_the_incremental_body(runs):
    fits = runs[0][0]["fits"]
    helpers.assert_same_run(fits["fused"], fits["incremental"])
    np.testing.assert_array_equal(fits["fused"]["metrics"]["accepts"],
                                  fits["incremental"]["metrics"]["accepts"])


@pytest.mark.parametrize("name", list(CASES) + list(PORT_ONLY))
def test_replicated_algebra_agrees_across_ranks(runs, name):
    """Every rank takes its accept decisions from its own copy of the
    D x D algebra: the copies are the same bits, and so are the histories
    every rank records."""
    helpers.assert_ranks_agree(runs[0], name)
