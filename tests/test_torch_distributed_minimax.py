"""The shard_map backend under Minimax Protection against the JAX
package's shard_map bodies: the incremental body at (alpha, delta) =
(1, 0.02) and (20, 0.01) — the robust objective, and with it the N/alpha
subsample drawn inside the body and the exact local diagonal (alpha = 20
alone: test_torch_distributed_api.py) — on the parity
cell of test_torch_distributed.py (Friedman-1, D = 5, N = 200 / 100, 3
sweeps, 60 robust solver steps, float64): histories and predictions at
1e-10, bytes equal, weights at 1e-10; every rank's history, weights and
A0 the same bits.  (Kept apart from test_torch_distributed.py so that each
file runs within a minute on one core.)
"""
import numpy as np
import pytest
import torch

import torch_distributed_helpers as helpers
from torch_distributed_helpers import shard_map_spec as _spec

CASES = {
    "incremental-a1-d0.02": _spec(delta=0.02),
    "incremental-a20-d0.01": _spec(alpha=20.0, delta=0.01),
}


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
    ranks = helpers.launch_cases(CASES)
    return ranks, ref.get()


@pytest.mark.parametrize("name", list(CASES))
def test_protected_body_matches_jax_f64(runs, name):
    ranks, ref = runs
    port = ranks[0]["fits"][name]
    helpers.assert_matches(port, ref[name], name)
    np.testing.assert_allclose(np.sum(port["weights"]), 1.0, rtol=1e-12)


@pytest.mark.parametrize("name", list(CASES))
def test_protected_algebra_agrees_across_ranks(runs, name):
    helpers.assert_ranks_agree(runs[0], name)
