#!/usr/bin/env python3
"""Run the sweep kernels (B5-B8) of one tree of this repository on seeded
inputs and save their outputs, or hold two such files to the same bits.

    python3 tools/sweep_compare.py TREE OUT.pt
    python3 tools/sweep_compare.py --check A.pt B.pt

TREE is a directory that holds a tree of the repository, for example a
`git archive` of another commit unpacked into a directory that .gitignore
lists; its src/repro_torch is imported and its kernels are built there.
The inputs are made by this checkout's code from fixed seeds (chip_smoke's
`spd_scene`), so two trees see the same operands: the probe (B5) and the
commit (B7) at D = 5, 100 and 300 (both probe routes), the commit with
can_tx true and false, by value and as device tensors, and with the
alpha > 1 diagonal operands; the batched probe (B6) and commit (B8) at
8 trials of D = 100, N = 262144 with one agent shared by the trials.
`--check` fails unless every output is equal bit for bit (torch.equal).
Needs one CUDA card.
"""
from __future__ import annotations

import math
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# (name, d, n, trials or None) of every operand set
CASES = [("d5", 5, 2000, None), ("d100", 100, 262144, None),
         ("d300", 300, 20001, None), ("b8_d100", 100, 262144, 8)]


def run(tree: str, out: str) -> None:
    sys.path.insert(0, HERE)
    import chip_smoke as cs                  # the operands of this checkout

    cs.phase_device()
    sys.path.insert(0, os.path.join(tree, "src"))
    import repro_torch
    cs.require(os.path.abspath(repro_torch.__file__).startswith(tree),
               f"imported {repro_torch.__file__}, not the tree {tree}")
    from repro_torch.kernels import _build
    from repro_torch.kernels.sweep import ops

    _build.build_all()
    dev = torch.device("cuda", 0)
    saved = {}
    for name, d, n, b in CASES:
        gen = torch.Generator(device=dev).manual_seed(d + n)
        lead = (b,) if b else ()
        r = torch.randn(lead + (d, n), generator=gen, device=dev)
        scenes = [cs.spd_scene(d, gen, dev) for _ in range(b or 1)]
        m_inv, s, eta = (torch.stack(x) for x in zip(*scenes))
        if not b:
            m_inv, s, eta = m_inv[0], s[0], eta[0]
        m_inv, s = m_inv.contiguous(), s.contiguous()
        delta = 0.05 * torch.randn(lead + (n,), generator=gen, device=dev)
        steps = torch.tensor([0.5 ** j for j in range(16)], device=dev) * math.sqrt(n)
        i = 37 % d
        outs = {"probe": ops.probe_sweep(r, m_inv, s, eta, i, steps)}
        for can in (True, False):
            outs[f"commit_{can}"] = ops.commit_sweep(r, m_inv, s, eta, i, delta, 1.0,
                                                     0.0, eta - 1.0, can)
            can_t = torch.full(lead or (1,), can, device=dev)
            outs[f"commit_t_{can}"] = ops.commit_sweep(
                r, m_inv, s, eta, i, delta, 1.0, 0.0, eta - 1.0,
                can_t if b else can_t[0])
        diag_add = 0.01 * torch.ones(lead or (), device=dev)
        outs["commit_split"] = ops.commit_sweep(r, m_inv, s, eta, i, delta, 0.0,
                                                diag_add, eta - 1.0, True)
        for key, val in outs.items():
            saved[f"{name}.{key}"] = [x.cpu() for x in val]
    torch.save(saved, out)
    print(f"sweep_compare: {len(saved)} outputs of {tree} saved to {out}")


def check(a: str, b: str) -> None:
    left, right = torch.load(a), torch.load(b)
    if sorted(left) != sorted(right):
        raise SystemExit("sweep_compare: the files hold different outputs")
    differ = [k for k in left
              if not all(torch.equal(x, y) for x, y in zip(left[k], right[k]))]
    if differ:
        raise SystemExit(f"sweep_compare: {len(differ)} outputs differ: {differ}")
    print(f"sweep_compare: all {len(left)} outputs equal bit for bit")


if __name__ == "__main__":
    if sys.argv[1] == "--check":
        check(sys.argv[2], sys.argv[3])
    else:
        run(os.path.abspath(sys.argv[1]), sys.argv[2])
