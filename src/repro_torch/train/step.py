"""Training step (twin of repro.train.step): loss and gradient (with
gradient-accumulation microbatching), global-norm clip, AdamW update, LR
schedule.

The step runs eagerly (no torch.compile); the gradients come from
torch.autograd, through the B9 and B11 backward kernels on the card.  The
dtypes are the JAX package's (repro/train/step.py:76-93): with microbatch
> 1 each microbatch's gradients are summed into fp32 zeros, divided by the
count and clipped in fp32; with microbatch == 1 they stay in the parameters'
dtype (bf16 on the full configs) through the clip.  AdamW's moments are
kept in cfg.moment_dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.api.runner import resolve_device
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update, clip_by_global_norm,
                               cosine_warmup)
from repro_torch.optim.clip import tree_leaves, tree_map

__all__ = ["TrainState", "init_state", "make_train_step", "train_state_specs"]


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: dict
    step: torch.Tensor          # int32, 0-d


def _adamw_config(cfg: ModelConfig, run: RunConfig) -> AdamWConfig:
    return AdamWConfig(b1=run.b1, b2=run.b2, weight_decay=run.weight_decay,
                       moment_dtype=cfg.moment_dtype)


def init_state(model, seed: int, run: RunConfig, device="cuda") -> TrainState:
    """Parameters from `model.init(seed)` on `device` (the card unless asked
    otherwise), zero moments and step."""
    dev = resolve_device(device, "repro_torch.train.init_state")
    params = model.init(seed=seed, device=dev)
    return TrainState(params=params, opt=adamw_init(params, _adamw_config(model.cfg, run)),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def train_state_specs(model, run: RunConfig) -> TrainState:
    """The TrainState's leaves as models.model.Spec (shape, dtype) records,
    from an init under FakeTensorMode: nothing is allocated (the JAX twin
    uses jax.eval_shape)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.model import Spec

    with FakeTensorMode():
        state = init_state(model, 0, run, device="cpu")
    spec = lambda t: Spec(tuple(t.shape), t.dtype)  # noqa: E731
    return TrainState(params=tree_map(spec, state.params),
                      opt={"mu": tree_map(spec, state.opt["mu"]),
                           "nu": tree_map(spec, state.opt["nu"]),
                           "count": spec(state.opt["count"])},
                      step=spec(state.step))


def _microbatches(batch: dict, n: int) -> dict:
    """Split the batch dim into n chunks -> leaves (n, b/n, ...); the vlm
    family's pos_ids (3, B, S) split at dim 1 -> (n, 3, B/n, S).  (The JAX
    twin picks the axis by shape: dim 0 wherever n divides it, which for
    pos_ids is dim 1 at the configs' n of 1 and 2, and dim 0 at n = 3.)"""
    out = {}
    for k, x in batch.items():
        dim = 1 if k == "pos_ids" else 0
        if x.shape[dim] % n:
            raise ValueError(f"microbatch: {k} of batch {x.shape[dim]} does not split into {n}")
        split = x.reshape(*x.shape[:dim], n, x.shape[dim] // n, *x.shape[dim + 1:])
        out[k] = split.movedim(dim, 0)
    return out


def make_train_step(model, run: RunConfig) -> Callable:
    """train_step(state, batch) -> (new state, {"loss", "grad_norm", "lr"});
    the new state's tensors are new, the old state is left as it was."""
    cfg: ModelConfig = model.cfg
    ocfg = _adamw_config(cfg, run)

    def grad_fn(params, batch) -> Tuple[torch.Tensor, Any]:
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, _ = model.loss(leaves, batch)
        flat = list(tree_leaves(leaves))
        grads = iter(torch.autograd.grad(loss, flat))
        return loss.detach(), tree_map(lambda _: next(grads), leaves)

    def train_step(state: TrainState, batch: dict) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        n = max(1, cfg.microbatch)
        if n > 1:
            mb = _microbatches(batch, n)
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), state.params)
            lsum = torch.zeros((), dtype=torch.float32, device=state.step.device)
            for i in range(n):
                loss, g = grad_fn(state.params, {k: v[i] for k, v in mb.items()})
                tree_map(lambda a, b: a.add_(b.to(a.dtype)), gsum, g)
                del g                   # (in place: one fp32 tree, not three, at a time)
                lsum = lsum + loss
            count = torch.tensor(float(n), dtype=torch.float32, device=lsum.device)
            grads = tree_map(lambda g: g.div_(count), gsum)
            del gsum
            loss = lsum / count
        else:
            loss, grads = grad_fn(state.params, batch)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, run.grad_clip)
            lr = cosine_warmup(state.step, peak_lr=run.learning_rate,
                               warmup_steps=run.warmup_steps, total_steps=run.total_steps)
            new_params, new_opt = adamw_update(grads, state.opt, state.params, ocfg, lr)
        new_state = TrainState(params=new_params, opt=new_opt, step=state.step + 1)
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step
