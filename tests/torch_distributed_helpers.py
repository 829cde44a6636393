"""Helpers of the shard_map parity tests (tests/test_torch_distributed*.py).

Everything a spawned rank unpickles lives here, in a module that imports
torch and repro_torch only, never jax or repro: the NaN codec, and
`fit_cases`, the rank function that fits a list of specs in place on the
launched group.  `Reference` runs the JAX package's shard_map fits of the
same specs in one subprocess with D host devices and float64 (the pytest
process keeps its own XLA flags and precision).
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from repro_torch import api as tapi
from repro_torch import transport as ttransport
from repro_torch.core import distributed
from repro_torch.transport import codecs as tcodecs

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@dataclasses.dataclass(frozen=True)
class NaNCodec(tcodecs.Codec):
    """The reference sanitizer test's codec: every delivered payload
    poisoned."""

    def decode(self, payload):
        return payload * float("nan")

    def nbytes(self, n_elems: int) -> float:
        return float(8 * n_elems)

    def is_identity_for(self, dtype) -> bool:
        return False


def shard_map_spec(**solver) -> dict:
    """The parity cell as a spec dict: Friedman-1, one attribute an agent,
    N = 200 train and 100 test, 3 sweeps without the eps stop, 60 robust
    solver steps, on the shard_map backend."""
    s = {"n_sweeps": 3, "eps": 0.0, "minimax_steps": 60}
    s.update(solver)
    return {"data": {"n_train": 200, "n_test": 100, "seed": 3}, "solver": s,
            "backend": {"name": "shard_map"}, "seed": 1}


def register_nan_codec() -> None:
    """"nan_injector" in the port's codec registry (idempotent)."""
    if "nan_injector" not in tcodecs.CODECS:
        ttransport.register_codec("nan_injector")(
            lambda: NaNCodec(name="nan_injector"))


def summary(res) -> dict:
    """A Result as plain lists and numpy arrays."""
    h = res.history
    out = {"train_mse": list(h.train_mse), "test_mse": list(h.test_mse),
           "eta": list(h.eta), "bytes": list(h.bytes_transmitted),
           "weights": res.weights.cpu().numpy(), "f": res.f.cpu().numpy(),
           "metrics": None}
    if res.metrics is not None:
        out["metrics"] = {k: np.asarray(v) for k, v in res.metrics.taps.items()}
    return out


FOREIGN = ("jax", "jaxlib", "repro")


def foreign_modules() -> list:
    """Modules of jax or of the JAX package loaded in this process."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FOREIGN)


def fit_cases(group, cases: dict, batches: dict = None) -> dict:
    """A launched rank's work: the group's collectives on known payloads,
    then `repro_torch.api.fit(spec, device="cpu")` of every case in place
    on the launched group (float64), each with this rank's final weights
    and A0 (distributed.last_ranks), then every batch case as
    batch_fit(compiled=False) of two trials beside fit(trial_spec(spec,
    1)), and the foreign modules this rank has loaded."""
    register_nan_codec()
    torch.set_default_dtype(torch.float64)
    me, d = group.rank, group.size
    row = torch.arange(7, dtype=torch.float64) * 0.1 + me / 3.0
    owner = 2 % d
    masked = group.psum(row if me == owner else torch.zeros_like(row))
    out = {"gathered": group.all_gather(row).numpy(), "row": row.numpy(),
           "masked": masked.numpy(), "owner": owner, "fits": {}, "batches": {}}
    for name, d_spec in cases.items():
        try:
            res = tapi.fit(tapi.spec_from_dict(d_spec), device="cpu")
        except Exception as exc:        # the test asserts on it
            out["fits"][name] = {"error": type(exc).__name__,
                                 "message": str(exc)}
            continue
        s = summary(res)
        rep = distributed.last_ranks()[0]
        s["rank_weights"], s["rank_a0"] = rep.get("weights"), rep.get("a0")
        out["fits"][name] = s
    for name, d_spec in (batches or {}).items():
        spec = tapi.spec_from_dict(d_spec)
        rs = tapi.batch_fit(spec, 2, device="cpu", compiled=False)
        one = tapi.fit(tapi.trial_spec(spec, 1), device="cpu")
        out["batches"][name] = {"trials": [summary(r) for r in rs.results],
                                "fit1": summary(one)}
    out["foreign"] = foreign_modules()
    return out


def launch_cases(cases: dict, batches: dict = None, d: int = 5) -> list:
    """fit_cases on D launched ranks: every rank's return value."""
    dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        return distributed.launch(fit_cases, d, (cases, batches))
    finally:
        torch.set_default_dtype(dt)


def raise_in_rank(group, rank: int, exc: Exception, pid_dir: str):
    """Rank `rank` raises `exc`; every other rank waits on a gather that
    never completes.  Each rank writes its pid into `pid_dir` first."""
    with open(os.path.join(pid_dir, f"pid-{group.rank}"), "w") as fh:
        fh.write(str(os.getpid()))
    group.all_gather(torch.zeros((1,), dtype=torch.float64))   # all wrote
    if group.rank == rank:
        raise exc
    group.all_gather(torch.zeros((1,), dtype=torch.float64))
    return group.rank


def skip_collective(group, seconds: float):
    """Rank 1 skips the gather rank 0 waits on, and stays alive."""
    import time

    if group.rank != 1:
        group.all_gather(torch.zeros((1,), dtype=torch.float64))
    else:
        time.sleep(seconds)
    return group.rank


def card_kernels(group, d: int, n: int) -> dict:
    """A rank on cuda:0: B1 (gram) and B3 (row_gram) on its own seeded
    rows, each against its plain version on the CPU, the launches this
    rank counted, and the ranks' row products gathered (through the
    host)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.gram import ops, ref

    gen = torch.Generator().manual_seed(100 + group.rank)
    r = torch.randn((d, n), generator=gen, dtype=torch.float32)
    v = torch.randn((n,), generator=gen, dtype=torch.float32)
    got_g = ops.gram(r.to("cuda"))
    got_r = ops.row_gram(v.to("cuda"), r.to("cuda"))
    launches = {k: _build.LAUNCHES[k] for k in ("gram", "row_gram")}
    want_g, want_r = ref.gram_ref(r), ref.row_gram_ref(v, r)

    def err(got, want):
        return float((got.cpu() - want).abs().max() / want.abs().max())

    gathered = group.all_gather(got_r)
    return {"rank": group.rank, "launches": launches,
            "gram_err": err(got_g, want_g), "row_gram_err": err(got_r, want_r),
            "row": got_r.cpu().numpy(), "gathered": gathered.cpu().numpy(),
            "device": str(gathered.device), "staged": group.staged_bytes}


# ------------------------------------------------------- the JAX reference

_REFERENCE = r"""
import json, sys
import jax, numpy as np
from repro import api
from repro import transport as jtransport
from repro.transport import codecs as jcodecs
import dataclasses, jax.numpy as jnp

@dataclasses.dataclass(frozen=True)
class NaNCodec(jcodecs.Codec):
    def decode(self, payload):
        return payload * jnp.nan
    def nbytes(self, n_elems):
        return float(8 * n_elems)
    def is_identity_for(self, dtype):
        return False

jtransport.register_codec("nan_injector")(lambda: NaNCodec(name="nan_injector"))
cases = json.load(open(sys.argv[1]))
out = {}
with jax.enable_x64(True):
    for name, d in cases.items():
        try:
            r = api.fit(api.spec_from_dict(d))
        except Exception as e:
            out[name] = {"error": type(e).__name__,
                         "message": str(e).split(" (`check` failed)")[0]}
            continue
        h = r.history
        out[name] = {"train_mse": h.train_mse, "test_mse": h.test_mse,
                     "eta": h.eta, "bytes": h.bytes_transmitted,
                     "weights": np.asarray(r.weights).tolist(),
                     "f": np.asarray(r.f).tolist(),
                     "metrics": None if r.metrics is None else
                     {k: np.asarray(v).tolist() for k, v in r.metrics.taps.items()}}
json.dump(out, open(sys.argv[2], "w"))
"""


class Reference:
    """The JAX package's shard_map fits of `cases`, running in a
    subprocess with `devices` host devices from construction on; `get()`
    waits and returns {name: record}."""

    def __init__(self, cases: dict, devices: int = 5):
        self._dir = tempfile.TemporaryDirectory(prefix="shard_map_ref_")
        src = os.path.join(self._dir.name, "cases.json")
        self._out = os.path.join(self._dir.name, "out.json")
        with open(src, "w") as fh:
            json.dump(cases, fh)
        env = dict(os.environ)
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.path.join(REPO, "src")
        self._proc = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, src, self._out], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._result = None

    def get(self) -> dict:
        if self._result is None:
            _, err = self._proc.communicate(timeout=600)
            assert self._proc.returncode == 0, err[-3000:]
            with open(self._out) as fh:
                self._result = json.load(fh)
            self._dir.cleanup()
        return self._result


def assert_same_run(got: dict, want: dict) -> None:
    """Two runs gave the same histories, weights and predictions, bit for
    bit."""
    for key in ("train_mse", "test_mse", "eta", "bytes"):
        assert got[key] == want[key], key
    for key in ("weights", "f"):
        assert np.array_equal(got[key], want[key]), key


def assert_ranks_agree(ranks: list, name: str) -> None:
    """Every rank of a launch recorded the same history and reached the
    same final weights and A0, bit for bit."""
    first = ranks[0]["fits"][name]
    assert first["rank_a0"] is not None
    for r in ranks[1:]:
        mine = r["fits"][name]
        for key in ("train_mse", "test_mse", "eta", "bytes"):
            assert mine[key] == first[key], (name, key)
        for key in ("rank_weights", "rank_a0", "weights", "f"):
            assert np.array_equal(mine[key], first[key]), (name, key)


def assert_matches(port: dict, ref: dict, name: str, rtol: float = 1e-10) -> None:
    """Histories at rtol, byte histories exactly, weights and predictions
    at rtol (absolute floor 1e-12)."""
    for key in ("train_mse", "test_mse", "eta"):
        np.testing.assert_allclose(port[key], ref[key], rtol=rtol,
                                   err_msg=f"{name}: {key}")
    assert port["bytes"] == ref["bytes"], (name, port["bytes"], ref["bytes"])
    np.testing.assert_allclose(port["weights"], np.asarray(ref["weights"]),
                               rtol=rtol, atol=1e-12, err_msg=f"{name}: weights")
    np.testing.assert_allclose(port["f"], np.asarray(ref["f"]), rtol=rtol,
                               atol=1e-12, err_msg=f"{name}: f")
