"""The shard_map backend's launcher: `repro_torch.api.fit` starts one rank
an agent itself (torch.multiprocessing, spawn, a FileStore), hands each
rank its own columns and returns rank 0's result, and a rank's failure
reaches the caller.

  * A fit from this process (cosine data, 2 attributes one an agent, so
    2 ranks; alpha = 20, float64) equals repro.api.fit's shard_map run:
    histories and predictions at 1e-10, bytes equal; every rank reports
    its sweeps, its collectives and the same final weights.
  * (A NaN-decoding codec's CheckError crosses from the ranks to the
    caller in test_torch_distributed_api.py.)
  * An exception raised in rank 2 of 3 reaches the caller as itself (its
    type and message), and no rank is left running.
  * A rank that skips a collective ends the run with the group's timeout
    error (the timeout made short here), not a hang.
"""
import os
import time

import numpy as np
import pytest
import torch

import torch_distributed_helpers as helpers
from repro_torch import api as tapi
from repro_torch.core import distributed


def _cosine(**over):
    d = {"data": {"source": "cosine", "n_attrs": 2, "n_train": 160,
                  "n_test": 80, "seed": 4},
         "solver": {"n_sweeps": 3, "eps": 0.0, "alpha": 20.0},
         "backend": {"name": "shard_map"}, "seed": 2}
    d.update(over)
    return d


CASES = {"launched": _cosine()}


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(single_thread):
    return helpers.Reference(CASES, devices=2)


@pytest.fixture
def f64():
    dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(dt)


def test_fit_launches_its_ranks_and_matches_jax(reference, f64):
    res = tapi.fit(tapi.spec_from_dict(CASES["launched"]), device="cpu")
    helpers.assert_matches(helpers.summary(res), reference.get()["launched"],
                           "launched")
    reports = distributed.last_ranks()
    assert [r["rank"] for r in reports] == [0, 1]
    for r in reports:
        assert len(r["sweep_seconds"]) == 3
        assert r["collectives"]["calls"] > 0
        assert r["collectives"]["staged_bytes"] == 0      # CPU tensors
        assert np.array_equal(r["weights"], reports[0]["weights"])
        assert np.array_equal(r["a0"], reports[0]["a0"])
    np.testing.assert_array_equal(reports[0]["weights"], res.weights.numpy())


def test_rank_exception_reaches_the_caller_as_itself(tmp_path):
    with pytest.raises(ValueError, match="agent 2 refuses") as err:
        distributed.launch(helpers.raise_in_rank, 3,
                           (2, ValueError("agent 2 refuses"), str(tmp_path)))
    assert "rank 2" in err.value.__notes__[0]
    pids = [int((tmp_path / f"pid-{r}").read_text()) for r in range(3)]
    for pid in pids:                   # every rank ended, none left waiting
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_skipped_collective_times_out():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="[Tt]imed out"):
        distributed.launch(helpers.skip_collective, 2, (60.0,), timeout=2.0)
    assert time.perf_counter() - t0 < 45.0
