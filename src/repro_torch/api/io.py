"""Result persistence on top of checkpoint.io (twin of repro.api.io).

Layout of a saved result directory, the JAX package's, so either package
loads the other's results:

    result.json        {"spec": the spec tree as JSON, "history": History}
    ckpt_00000000.npz  params / weights / f
    ckpt_00000000.json checkpoint manifest

`load_result` rebuilds the arrays' structure from the spec alone and, with
`with_data`, the Dataset too: both packages draw it from the seed.  As in
the JAX package, weights and f come back as float32 and params in the
dtypes of `family.init` (float32; the mlp family's weights in torch's
default float dtype, its biases float32), a dict for mlp.
"""
from __future__ import annotations

import json
import os

import torch

from repro_torch.api.result import History, Result
from repro_torch.api.runner import resolve_device
from repro_torch.api.specs import ExperimentSpec, spec_from_dict, spec_to_dict
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core.icoa import init_keys

__all__ = ["save_result", "load_result"]

_META = "result.json"


def save_result(directory: str, result: Result) -> str:
    os.makedirs(directory, exist_ok=True)
    ckpt_io.save_checkpoint(directory, 0, {"params": result.params,
                                           "weights": result.weights,
                                           "f": result.f})
    with open(os.path.join(directory, _META), "w") as fh:
        json.dump({"spec": spec_to_dict(result.spec),
                   "history": result.history.as_dict()}, fh, indent=1)
    return directory


def load_result(directory: str, with_data: bool = True,
                device="cuda") -> Result:
    """Restore a saved Result on `device` (the card unless asked otherwise).
    `with_data=True` draws the Dataset again from the spec, for
    `minimax_upper_bound` and predictions on the training data."""
    dev = resolve_device(device, "repro_torch.api.load")
    with open(os.path.join(directory, _META)) as fh:
        meta = json.load(fh)
    spec: ExperimentSpec = spec_from_dict(meta["spec"])
    spec.validate()

    data = spec.data.build(dev) if with_data else None
    groups = spec.data.groups
    d, n_cols = len(groups), len(groups[0])
    family = spec.agent.resolve(n_cols)
    like = {"params": family.init(init_keys(spec.seed, d, dev)),
            "weights": torch.zeros((d,), dtype=torch.float32, device=dev),
            "f": torch.zeros((d, spec.data.n_train), dtype=torch.float32,
                             device=dev)}
    tree = ckpt_io.restore_checkpoint(directory, 0, like)
    return Result(spec=spec, family=family, params=tree["params"],
                  weights=tree["weights"], f=tree["f"],
                  history=History.from_dict(meta["history"]), data=data)
