#!/usr/bin/env python3
"""Run the flash-decode kernel (B10) of one tree of this repository on
seeded inputs at every group size up to 8 and save its outputs, or hold two
such files to the same bits.

    python3 tools/decode_compare.py TREE OUT.pt
    python3 tools/decode_compare.py --check A.pt B.pt

TREE is a directory that holds a tree of the repository, for example a
`git archive` of another commit unpacked into a directory that .gitignore
lists; its src/repro_torch is imported and its kernels are built there.
The inputs come from fixed seeds, so two trees see the same operands: the
smollm serving shape (B=8, cache 1088, 15/5 heads of 64) in bf16 and fp32,
G = 1, 2, 4 and 8 at dh 64 and 128, dh 80 with a sliding window, and a
cache cut into many chunks (B=1, S=20000).  `--check` fails unless every
output is equal bit for bit (torch.equal).  Needs one CUDA card.
"""
from __future__ import annotations

import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (b, s, hq, hkv, dh, idx, window) of every operand set
CASES = [(8, 1088, 15, 5, 64, 1087, 0), (2, 500, 4, 4, 64, 400, 0),
         (2, 500, 8, 4, 128, 499, 0), (3, 999, 16, 4, 64, 700, 0),
         (3, 999, 8, 1, 128, 998, 0), (2, 300, 3, 1, 80, 250, 64),
         (1, 20000, 8, 1, 128, 19999, 0)]


def run(tree: str, out: str) -> None:
    sys.path.insert(0, HERE)
    import chip_smoke as cs                  # the device check of this checkout

    cs.phase_device()
    sys.path.insert(0, os.path.join(tree, "src"))
    import repro_torch
    cs.require(os.path.abspath(repro_torch.__file__).startswith(tree),
               f"imported {repro_torch.__file__}, not the tree {tree}")
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_decode import ops

    _build.build_all()
    dev = torch.device("cuda", 0)
    saved = {}
    for dt in (torch.bfloat16, torch.float32):
        for b, s, hq, hkv, dh, idx, window in CASES:
            gen = torch.Generator(device=dev).manual_seed(b * s + hq * dh)
            shapes = ((b, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh))
            q, k, v = (torch.randn(sh, generator=gen, dtype=torch.float32,
                                   device=dev).to(dt) for sh in shapes)
            got = ops.flash_decode(q, k, v, idx, window=window)
            saved[f"{dt}.{(b, s, hq, hkv, dh, idx, window)}"] = got.cpu()
    torch.save(saved, out)
    print(f"decode_compare: {len(saved)} outputs of {tree} saved to {out}")


def check(a: str, b: str) -> None:
    left, right = torch.load(a), torch.load(b)
    if sorted(left) != sorted(right):
        raise SystemExit("decode_compare: the files hold different outputs")
    differ = [k for k in left if not torch.equal(left[k], right[k])]
    if differ:
        raise SystemExit(f"decode_compare: {len(differ)} outputs differ: {differ}")
    print(f"decode_compare: all {len(left)} outputs equal bit for bit")


if __name__ == "__main__":
    if sys.argv[1] == "--check":
        check(sys.argv[2], sys.argv[3])
    else:
        run(os.path.abspath(sys.argv[1]), sys.argv[2])
