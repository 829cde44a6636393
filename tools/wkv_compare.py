#!/usr/bin/env python3
"""Time the WKV kernel (B11) and the rwkv6-1.6b prefill of one tree of this
repository on one NVIDIA H100.

    python3 tools/wkv_compare.py [TREE]

TREE (default: this checkout) is a directory that holds a tree of the
repository, for example a `git archive` of another commit unpacked into a
directory that .gitignore lists.  Its src/repro_torch is imported and its
kernels are built there; the measuring code is this checkout's
chip_smoke.py (`time_ms`, `prefill_split`), so every tree is timed by the
same code.  To compare two trees, run them in turns in one call on one card
(parent, change, change, parent).

Measured, at the rwkv6 serving shape: B11 on r, k, v, w (B=8, S=1024, H=32,
dh=64, fp32, moderate decay) against the plain recurrence at 1e-5 normwise,
then its device time (CUDA events, as chip_smoke phase 3); the full
rwkv6-1.6b config (24 layers, bf16, random weights from seed 0) prefilling
a batch of 8 1024-token prompts: the median host time of 5 warm prefills
(each ended by a synchronize) and one more under torch.profiler, split into
B11's device time and its share of the busy time.  Prints one JSON line.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    sys.path.insert(0, HERE)
    import chip_smoke as cs                          # the measuring code of this checkout

    smi = cs.phase_device()
    sys.path.insert(0, os.path.join(tree, "src"))
    import repro_torch
    cs.require(os.path.abspath(repro_torch.__file__).startswith(tree),
               f"imported {repro_torch.__file__}, not the tree {tree}")
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv import ops as wkv_ops
    from repro_torch.kernels.wkv import ref as wkv_ref
    from repro_torch.launch.serve import build_prompt
    from repro_torch.models import build_model

    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, s, h, dh = 8, 1024, 32, 64
    r, k, v, z = (torch.randn((b, s, h, dh), generator=gen, device="cuda") for _ in range(4))
    w = cs.wkv_decay(z, "moderate")
    u = 0.1 * torch.randn((h, dh), generator=gen, device="cuda")
    out, state = wkv_ops.wkv_chunked(r, k, v, w, u)
    want, want_state = wkv_ref.wkv_ref(r, k, v, w, u)
    err = max(cs.compare("wkv out", out, want, 1e-5)[1],
              cs.compare("wkv state", state, want_state, 1e-5)[1])
    del want, want_state
    wkv_ms = cs.time_ms(lambda: wkv_ops.wkv_chunked(r, k, v, w, u))
    del r, k, v, w, z, out, state

    cfg = get_config("rwkv6-1.6b")
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    prompt = build_prompt(cfg, 8, 1024, "cuda")
    for _ in range(2):
        model.prefill(params, prompt)
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, prompt)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    geometry = (wkv_ops.wkv_geometry(8, 1024, cfg.d_model // cfg.rwkv_head_dim,
                                     cfg.rwkv_head_dim)
                if hasattr(wkv_ops, "wkv_geometry") else None)
    split = cs.prefill_split(model, params, prompt, "rwkv6-1.6b", geometry)
    print(json.dumps({"tree": tree, "card": smi, "wkv_ms": wkv_ms, "wkv_normwise_err": err,
                      "prefill_ms_median": statistics.median(runs), "prefill_ms_runs": runs,
                      "prefill_split": split}))


if __name__ == "__main__":
    main()
