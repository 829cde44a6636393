#!/usr/bin/env python3
"""Host-time the deployment sweep of one tree of this repository on one
NVIDIA H100.

    python3 tools/sweep_timing.py [TREE]

TREE (default: this checkout) is a directory that holds a tree of the
repository, for example a `git archive` of another commit unpacked into a
directory that .gitignore lists.  Its src/repro_torch is imported and its
kernels are built there; the operands are made here with a seeded
torch.Generator on the card (D = 100 agents of one column, N = 262144,
polynomial agents), so every tree sweeps the same tensors through the same
call, `icoa.sweep(family, cfg, params, f, xcols, y)` with use_kernel, from
the warm start.  Per engine (fused, incremental): one warm-up sweep, then
seven sweeps each ended by a synchronize; prints one JSON line with every
sweep's milliseconds and their median.  To compare two trees, run them in
turns in one call on one card (parent, change, change, parent).
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
    if not torch.cuda.is_available():
        raise SystemExit("sweep_timing: needs a CUDA card")
    sys.path.insert(0, os.path.join(tree, "src"))
    import repro_torch
    if not os.path.abspath(repro_torch.__file__).startswith(tree):
        raise SystemExit(f"imported {repro_torch.__file__}, not the tree {tree}")
    from repro_torch.agents.polynomial import PolynomialFamily
    from repro_torch.core import icoa
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(5)
    d, n = 100, 262144
    xcols = torch.randn((d, n, 1), generator=gen, device="cuda")
    y = torch.rand((n,), generator=gen, device="cuda")
    family = PolynomialFamily(n_cols=1)
    state = icoa.init_state(family, xcols, y)
    out = {"tree": tree}
    for engine in ("fused", "incremental"):
        cfg = icoa.ICOAConfig(engine=engine, use_kernel=True)
        icoa.sweep(family, cfg, state.params, state.f, xcols, y)
        runs = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            icoa.sweep(family, cfg, state.params, state.f, xcols, y)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        out[engine] = {"ms": runs, "median_ms": statistics.median(runs)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
