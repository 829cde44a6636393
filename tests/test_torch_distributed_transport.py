"""The shard_map backend's incremental body under the transport and fault
layers, against the JAX package's: the int8_affine codec on the ring
topology (every gathered and broadcast row through the relay), a
greedy_eta byte budget that runs out mid-run (the sweep-start order and
gates off the replicated CovState), drops with retries, and a crash
schedule (survivors-only weights) — the parity cell of
test_torch_distributed.py (Friedman-1, D = 5, N = 200 / 100, 3 sweeps,
float64): histories and predictions at 1e-10, the byte ledgers equal, the
weights at 1e-10; every rank's history, weights and A0 the same bits.
"""
import pytest
import torch

import torch_distributed_helpers as helpers
from torch_distributed_helpers import shard_map_spec as _spec

CASES = {
    "ring-int8_affine": dict(_spec(), transport={"topology": "ring",
                                                 "codec": "int8_affine"}),
    # a clean sweep costs 16,000 bytes: the budget runs out in sweep 2
    "greedy_eta-budget": dict(_spec(), transport={"byte_budget": 20000.0,
                                                  "policy": "greedy_eta"}),
    "drop": dict(_spec(), faults={"seed": 5, "drop_rate": 0.4,
                                  "max_retries": 2}),
    "crash": dict(_spec(), faults={"crash": [[1, 1, 3], [3, 0, -1]]}),
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
def test_transport_and_faults_match_jax_f64(runs, name):
    ranks, ref = runs
    helpers.assert_matches(ranks[0]["fits"][name], ref[name], name)


def test_budget_and_faults_moved_the_ledger(runs):
    """The cases exercise what they name: the budget stops the spending,
    the drops retransmit, the crash stops an agent's traffic and its
    weight (agent 3 never rejoins)."""
    fits = runs[0][0]["fits"]
    clean = 16000.0
    assert sum(fits["greedy_eta-budget"]["bytes"]) <= 20000.0
    assert 0.0 in fits["greedy_eta-budget"]["bytes"][2:]
    assert max(fits["drop"]["bytes"]) > clean
    assert max(fits["crash"]["bytes"][1:]) < clean
    assert fits["crash"]["weights"][3] == 0.0


@pytest.mark.parametrize("name", list(CASES))
def test_gates_agree_across_ranks(runs, name):
    helpers.assert_ranks_agree(runs[0], name)
