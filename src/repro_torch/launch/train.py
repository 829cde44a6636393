"""Training launcher (twin of repro.launch.train): `--arch <id>` + input
shape, run eagerly on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --smoke --steps 50 --seq 128 --batch 8 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \
        --steps 20 --seq 1024 --batch 4                     # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch jamba-v0.1-52b \
        --layers 2 --attn-period 2 --steps 6 --seq 1024 --batch 4   # card

The flags and the printed lines are the JAX launcher's; `--device` (the
card unless asked otherwise), `--seed` (the parameters' generator; the
JAX launcher's PRNGKey(seed) gives other numbers), and `--layers` and
`--attn-period` (the config's n_layers and attn_period: a depth that fits
one card, as the moe and hybrid configs do not) are the port's.  Batches
are the JAX launcher's tokens (`data.lm.lm_batches`, seed 0).  Checkpoints
hold the parameters in the JAX package's stacked layout
(convert.lm_params_to_tree) through checkpoint.io, so either package
restores the other's.  There is no mesh: sharding waits for ROADMAP
A11.  `run(argv)` is the loop itself and returns the final state and each
step's record (loss, grad norm, lr, its time), which `main` prints.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Tuple

import torch

from repro_torch.api.runner import resolve_device
from repro_torch.checkpoint.io import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import ARCH_IDS, RunConfig, get_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_tree
from repro_torch.data.lm import lm_batches
from repro_torch.models import build_model
from repro_torch.train import TrainState, init_state, make_train_step


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--attn-impl", choices=["eager", "chunked"])
    ap.add_argument("--rwkv-chunk", type=int)
    ap.add_argument("--layers", type=int, help="keep the config's first N layers")
    ap.add_argument("--attn-period", type=int, help="hybrid: attention every N layers")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def run(argv=None, echo: bool = False) -> Tuple[object, TrainState, List[dict]]:
    """The training loop of `argv` -> (model, final state, one record a
    step: step, loss, grad_norm, lr as floats, ms (the host's clock around
    the step, synchronised on the card)); with `echo`, the JAX launcher's
    lines are printed as it goes."""
    args = parse(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    kw = {}
    if args.attn_impl:
        kw["attn_impl"] = args.attn_impl
    if args.rwkv_chunk is not None:
        kw["rwkv_chunk"] = args.rwkv_chunk
    if args.layers is not None:
        kw["n_layers"] = args.layers
    if args.attn_period is not None:
        kw["attn_period"] = args.attn_period
    if kw:
        cfg = dataclasses.replace(cfg, **kw)

    dev = resolve_device(args.device, "repro_torch.launch.train")
    model = build_model(cfg)
    run_cfg = RunConfig(learning_rate=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                        total_steps=args.steps, seed=args.seed)

    state = init_state(model, run_cfg.seed, run_cfg, device=dev)
    if args.ckpt_dir and (step0 := latest_step(args.ckpt_dir)) is not None:
        like = lm_params_to_tree(cfg, state.params)
        state = dataclasses.replace(state, params=lm_params_from_numpy(
            cfg, restore_checkpoint(args.ckpt_dir, step0, like), dev))
        if echo:
            print(f"restored step {step0} from {args.ckpt_dir}")

    step_fn = make_train_step(model, run_cfg)
    stream = lm_batches(model, seq=args.seq, batch=args.batch, seed=0, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    log = []
    t0 = time.time()
    for i in range(args.steps):
        ts = time.perf_counter()
        state, met = step_fn(state, next(stream))
        sync()
        rec = {"step": i, **{k: float(v) for k, v in met.items()}}
        rec["ms"] = (time.perf_counter() - ts) * 1e3
        log.append(rec)
        if echo and (i % 10 == 0 or i == args.steps - 1):
            print(f"step {i:4d} loss {rec['loss']:.4f} "
                  f"gnorm {rec['grad_norm']:.2f} "
                  f"({(i + 1) * args.batch * args.seq / (time.time() - t0):.0f} tok/s)",
                  flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, i + 1, lm_params_to_tree(cfg, state.params))
    return model, state, log


def main(argv=None):
    run(argv, echo=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
