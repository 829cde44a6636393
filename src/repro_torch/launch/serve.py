"""Serving launcher (twin of repro.launch.serve): batched prefill + decode
for the ported architectures (the dense, ssm, moe and hybrid families).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --batch 8 --prompt-len 1024 --new-tokens 64          # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --smoke --batch 4 --prompt-len 64 --new-tokens 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \
        --smoke --device cpu

The full moe and hybrid configs (mixtral-8x22b, phi3.5-moe, jamba-v0.1-52b)
hold 84–282 GB of bf16 parameters, more than one 80 GB card.

Parameters are random, drawn from a torch.Generator seeded with 0 (the JAX
launcher's PRNGKey(0) gives other numbers); prompts come from the same
MarkovStream as the JAX launcher's.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api.runner import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.lm import MarkovStream
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine


def build_prompt(cfg, batch: int, prompt_len: int, device="cpu"):
    stream = MarkovStream(cfg.vocab_size, seed=0)
    toks = stream.sample(np.random.default_rng(0), batch, prompt_len)
    return {"tokens": torch.from_numpy(toks[:, :-1]).long().to(device)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    dev = resolve_device(args.device, "repro_torch.launch.serve")
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    engine = ServeEngine(model, temperature=args.temperature)
    prompt = build_prompt(cfg, args.batch, args.prompt_len, dev)
    generator = torch.Generator(device=dev).manual_seed(1) if args.temperature else None
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = engine.generate(params, prompt, max_new_tokens=args.new_tokens,
                             generator=generator)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"arch={cfg.arch_id} on {where}: generated {tuple(out.shape)} in "
          f"{dt:.3f}s ({args.batch * args.new_tokens / dt:.1f} tok/s, prefill "
          f"included)")
    print("sequence 0:", out[0].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
