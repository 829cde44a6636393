"""Serving launcher (twin of repro.launch.serve): batched prefill + decode
for every architecture (the dense, ssm, moe, hybrid, encdec and vlm
families).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --batch 8 --prompt-len 1024 --new-tokens 64          # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --smoke --batch 4 --prompt-len 64 --new-tokens 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \
        --batch 8 --prompt-len 384 --new-tokens 64           # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-7b \
        --smoke --device cpu

The full moe and hybrid configs (mixtral-8x22b, phi3.5-moe, jamba-v0.1-52b)
hold 84–282 GB of bf16 parameters, more than one 80 GB card.

Parameters are random, drawn from a torch.Generator seeded with 0 (the JAX
launcher's PRNGKey(0) gives other numbers); prompts come from the same
MarkovStream as the JAX launcher's, with its zero frames (encdec: 1500 of
them at the full config) or zero vision embeddings before the text and
M-RoPE positions 0..v+S-1 on all three streams (vlm).
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


def build_prompt(cfg, batch: int, prompt_len: int, device="cpu", seed=None):
    """The JAX launcher's prompt: prompt_len MarkovStream tokens (B, S),
    with zero frames (B, n_frames, D) for encdec, and zero vision embeddings
    (B, v, D) and pos_ids (3, B, v + S) for vlm.  With `seed` the frames or
    vision embeddings are float32 normals from a CPU generator seeded so,
    cast to the compute dtype (the same numbers on every device; zeros make
    every encoder row, or every vision token, alike)."""
    stream = MarkovStream(cfg.vocab_size, seed=0)
    toks = stream.sample(np.random.default_rng(0), batch, prompt_len)
    prompt = {"tokens": torch.from_numpy(toks[:, :-1]).long().to(device)}

    def stub(shape):
        if seed is None:
            return torch.zeros(shape, dtype=cfg.cdtype(), device=device)
        gen = torch.Generator(device="cpu").manual_seed(seed)
        return torch.randn(shape, generator=gen, dtype=torch.float32, device="cpu").to(
            device=device, dtype=cfg.cdtype())

    if cfg.family == "encdec":
        prompt["frames"] = stub((batch, cfg.n_frames, cfg.d_model))
    if cfg.family == "vlm":
        v = cfg.n_vision_tokens
        prompt["vision_embeds"] = stub((batch, v, cfg.d_model))
        s = prompt["tokens"].shape[1] + v
        prompt["pos_ids"] = torch.arange(s, dtype=torch.int64, device=device).expand(
            3, batch, s).contiguous()
    return prompt


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
