"""Carry data, solver state and LM parameters across from numpy (and so from
the JAX package) into the port's tensors.

With these a test starts the port's `sweep` from the exact state the JAX
package reached, or predicts with the JAX package's fitted coefficients:
the arrays keep their dtype and move to `device`.  `batch_from_numpy`
stacks numpy trial datasets into the (B, ...) tensors of icoa.run_scan, so
the port's batch and `jax.vmap` over the JAX package's run_scan see the same
arrays.  `lm_params_from_numpy` turns the JAX package's `Model.init` tree
into the port's per-layer LM parameters, `lm_params_to_tree` the port's
back into the JAX package's stacked layout (what the LM checkpoints store,
so that either package restores the other's), and `train_state_from_numpy`
carries a JAX TrainState (params, AdamW moments, counts) across.
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api.specs import Dataset
from repro_torch.core.icoa import ICOAState
from repro_torch.models.model import check_ported
from repro_torch.models.transformer import pattern_period

__all__ = ["batch_from_numpy", "dataset_from_numpy", "lm_params_from_numpy",
           "lm_params_to_tree", "params_from_numpy", "state_from_numpy",
           "train_state_from_numpy"]


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().clone().to(device)
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":       # numpy has no bf16: move the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def dataset_from_numpy(xcols, y, xcols_test, y_test,
                       groups: Sequence[Sequence[int]], device="cpu") -> Dataset:
    """A Dataset from (D, N, C) / (N,) / (D, N_test, C) / (N_test,) arrays."""
    g: List[List[int]] = [list(map(int, grp)) for grp in groups]
    return Dataset(_tensor(xcols, device), _tensor(y, device),
                   _tensor(xcols_test, device), _tensor(y_test, device), g)


def params_from_numpy(params, device="cpu"):
    """The JAX package's `Result.params`: (D, P) coefficients of the
    polynomial, linear and rff families, or the mlp family's dict of
    stacked arrays (w1 (D, C, H), b1 (D, H), ...), each leaf in its own
    dtype (float32 biases beside float64 weights under x64)."""
    if isinstance(params, dict):
        out = {str(k): _tensor(v, device) for k, v in params.items()}
        if len({v.shape[0] for v in out.values()}) != 1:
            raise ValueError(f"leaves disagree on the agent axis: "
                             f"{ {k: tuple(v.shape) for k, v in out.items()} }")
        return out
    p = _tensor(params, device)
    if p.dim() != 2:
        raise ValueError(f"expected (D, P) stacked params, got {tuple(p.shape)}")
    return p


def state_from_numpy(params, f, device="cpu") -> ICOAState:
    """An ICOAState from the JAX package's stacked params ((D, P), or the
    mlp family's dict) and prediction matrix f (D, N)."""
    return ICOAState(params=params_from_numpy(params, device),
                     f=_tensor(f, device))


def batch_from_numpy(xcols, y, xcols_test, y_test, device="cpu"
                     ) -> Tuple[torch.Tensor, ...]:
    """(xcols (B, D, N, C), y (B, N), xcols_test (B, D, N_test, C), y_test
    (B, N_test)) tensors for icoa.run_scan: each argument is a sequence of
    per-trial arrays (or one array whose first axis is the trial), stacked."""
    out = tuple(_tensor(np.stack(a), device)
                for a in (xcols, y, xcols_test, y_test))
    if out[0].dim() != 4 or out[1].dim() != 2:
        raise ValueError(f"expected xcols (B, D, N, C) and y (B, N), got "
                         f"{tuple(out[0].shape)} and {tuple(out[1].shape)}")
    if len({a.shape[0] for a in out}) != 1:
        raise ValueError(f"trial axes differ: {[a.shape[0] for a in out]}")
    return out


# the stacked subtrees of the JAX package's LM tree and the port's per-layer
# lists; every other top-level entry (embed, the norms, vlm's vision_proj)
# crosses as it is
_STACKED = ("blocks", "enc_layers", "dec_layers")
_LISTS = ("layers", "enc_layers", "dec_layers")


def lm_params_from_numpy(cfg, tree, device="cpu") -> dict:
    """The port's LM parameters from the JAX package's `Model.init` tree
    (as numpy arrays, e.g. `jax.tree.map(np.asarray, params)`).

    The JAX tree stacks each pattern position over the layer repetitions,
    `blocks/pos<p>/...` with a leading n_rep axis (e.g. mixer/wq of shape
    (L, d, Hq*dh) for a dense model); the port keeps one dict per layer, and
    layer i is repetition i // period of position i % period.  The encdec
    tree's `enc_layers` and `dec_layers` are stacked over their layers and
    become lists the same way.  Weights keep
    the JAX layout (x @ w), so the conversion only slices: no arithmetic,
    and both packages compute with the same numbers."""
    check_ported(cfg)

    def conv(node, pick=None) -> Any:
        if isinstance(node, dict):
            return {k: conv(v, pick) for k, v in node.items()}
        return _tensor(node if pick is None else node[pick], device)

    out = {k: conv(v) for k, v in tree.items() if k not in _STACKED}
    if cfg.family == "encdec":
        out["enc_layers"] = [conv(tree["enc_layers"], i) for i in range(cfg.n_enc_layers)]
        out["dec_layers"] = [conv(tree["dec_layers"], i) for i in range(cfg.n_layers)]
    else:
        period, blocks = pattern_period(cfg), tree["blocks"]
        out["layers"] = [conv(blocks[f"pos{i % period}"], i // period)
                         for i in range(cfg.n_layers)]
    return out


def lm_params_to_tree(cfg, params) -> dict:
    """The JAX package's `Model.init` layout of the port's LM parameters
    (or of any tree of their structure, AdamW's moments say):
    blocks/pos<p>/... stacked over the repetitions (encdec: enc_layers and
    dec_layers stacked over their layers), as new tensors on the
    parameters' device.  The inverse of lm_params_from_numpy, which also
    takes these tensors."""
    check_ported(cfg)

    def stack(nodes) -> Any:
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return torch.stack([n.detach() for n in nodes])

    def clone(node) -> Any:
        if isinstance(node, dict):
            return {k: clone(v) for k, v in node.items()}
        return node.detach().clone()

    out = {k: clone(v) for k, v in params.items() if k not in _LISTS}
    if cfg.family == "encdec":
        out["enc_layers"] = stack(params["enc_layers"])
        out["dec_layers"] = stack(params["dec_layers"])
    else:
        period, layers = pattern_period(cfg), params["layers"]
        out["blocks"] = {f"pos{p}": stack(layers[p::period]) for p in range(period)}
    return out


def train_state_from_numpy(cfg, params, opt, step, device="cpu"):
    """A train.TrainState from the JAX package's TrainState as numpy arrays:
    `params` and `opt`'s mu / nu in the `Model.init` layout, `opt`'s count
    and `step` int32 scalars (each leaf keeps its dtype)."""
    from repro_torch.train.step import TrainState   # train imports the model code

    def scalar(x) -> torch.Tensor:
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32, device=device)

    return TrainState(
        params=lm_params_from_numpy(cfg, params, device),
        opt={"mu": lm_params_from_numpy(cfg, opt["mu"], device),
             "nu": lm_params_from_numpy(cfg, opt["nu"], device),
             "count": scalar(opt["count"])},
        step=scalar(step))
