#!/usr/bin/env python3
"""Run one family of hand-written kernels of one tree of this repository on
seeded inputs and save their outputs, or hold two such files to the same
bits.

    python3 tools/kernel_compare.py KERNEL TREE OUT.pt
    python3 tools/kernel_compare.py --check A.pt B.pt

KERNEL is a key of CASES:

  attention  the flash-attention forward (B9) as serving calls it (no LSE
             buffer): the smollm serving shape (B=8, S=1024, 15/5 heads of
             64) and every (dtype, head dim) route of the wrapper's table,
             with ragged lengths, sliding windows and a non-causal call
             with Skv > Sq;
  decode     the flash-decode kernel (B10) in bf16 and fp32: the smollm
             serving shape (B=8, cache 1088, 15/5 heads of 64), G = 1, 2, 4
             and 8 at dh 64 and 128, dh 80 with a sliding window, and a
             cache cut into many chunks (B=1, S=20000);
  wkv        the WKV forward (B11) as the rwkv prefill calls it, out and
             final state: rwkv6's serving shape (B=8, S=1024, 32 heads of
             64), dh 32, ragged lengths, strong and weak decay, w exactly 0
             in places, and operands off 16-byte alignment (4-byte copies);
  sweep      the probe (B5) and the commit (B7) at D = 5, 100 and 300 (both
             probe routes), the commit with can_tx true and false, by value
             and as device tensors, and with the alpha > 1 diagonal
             operands; the batched probe (B6) and commit (B8) at 8 trials
             of D = 100, N = 262144 with one agent shared by the trials.

TREE is a directory that holds a tree of the repository, for example a
`git archive` of another commit unpacked into a directory that .gitignore
lists; its src/repro_torch is imported and its kernels are built there.
The inputs are made by this checkout's code from fixed seeds (the sweep's
by chip_smoke's `spd_scene`), so two trees see the same operands.
`--check` fails unless every output is equal bit for bit (torch.equal).
Needs one CUDA card.
"""
from __future__ import annotations

import math
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _qkv(dev, dt, seed, shapes):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(sh, generator=gen, dtype=torch.float32, device=dev).to(dt)
            for sh in shapes]


def attention(cs, dev) -> dict:
    from repro_torch.kernels.flash_attention import ops

    # (b, sq, skv, hq, hkv, dh, causal, window)
    cases = [(8, 1024, 1024, 15, 5, 64, 1, 0), (2, 333, 333, 15, 5, 64, 1, 100),
             (1, 77, 77, 3, 1, 80, 1, 16), (1, 200, 200, 12, 3, 128, 1, 0),
             (1, 300, 300, 8, 1, 128, 1, 16), (1, 40, 93, 6, 2, 64, 0, 0),
             (1, 40, 93, 6, 2, 128, 0, 0), (2, 1, 1, 4, 4, 128, 1, 0)]
    saved = {}
    for dt in (torch.bfloat16, torch.float32):
        for b, sq, skv, hq, hkv, dh, causal, window in cases:
            q, k, v = _qkv(dev, dt, b * sq + hq * dh + skv,
                           ((b, sq, hq, dh), (b, skv, hkv, dh), (b, skv, hkv, dh)))
            got = ops.flash_attention(q, k, v, causal=bool(causal), window=window)
            saved[f"{dt}.{(b, sq, skv, hq, hkv, dh, causal, window)}"] = [got]
    return saved


def decode(cs, dev) -> dict:
    from repro_torch.kernels.flash_decode import ops

    # (b, s, hq, hkv, dh, idx, window)
    cases = [(8, 1088, 15, 5, 64, 1087, 0), (2, 500, 4, 4, 64, 400, 0),
             (2, 500, 8, 4, 128, 499, 0), (3, 999, 16, 4, 64, 700, 0),
             (3, 999, 8, 1, 128, 998, 0), (2, 300, 3, 1, 80, 250, 64),
             (1, 20000, 8, 1, 128, 19999, 0)]
    saved = {}
    for dt in (torch.bfloat16, torch.float32):
        for b, s, hq, hkv, dh, idx, window in cases:
            q, k, v = _qkv(dev, dt, b * s + hq * dh,
                           ((b, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh)))
            got = ops.flash_decode(q, k, v, idx, window=window)
            saved[f"{dt}.{(b, s, hq, hkv, dh, idx, window)}"] = [got]
    return saved


def wkv(cs, dev) -> dict:
    from repro_torch.kernels.wkv import ops

    # (b, s, h, dh, decay shift of w = exp(-exp(z + shift)), zeros, 4-byte copies)
    cases = [(8, 1024, 32, 64, -1.0, 0, 0), (2, 333, 4, 64, 1.0, 0, 0),
             (1, 77, 8, 32, 1.0, 5, 0), (1, 5, 2, 64, -6.0, 0, 0),
             (2, 17, 3, 32, -1.0, 0, 1), (1, 100, 2, 64, 1.0, 3, 1)]
    saved = {}
    for b, s, h, dh, shift, zeros, off in cases:
        r, k, v, z = _qkv(dev, torch.float32, b * s + h * dh, [(b, s, h, dh)] * 4)
        w = torch.exp(-torch.exp(z + shift))
        if zeros:
            w[:, ::zeros, :, ::3] = 0.0
        u = 0.1 * _qkv(dev, torch.float32, s + dh, [(h, dh)])[0]
        if off:                                   # views that start 4 bytes in
            r, k, v, w = (torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape).copy_(x)
                          for x in (r, k, v, w))
        saved[str((b, s, h, dh, shift, zeros, off))] = list(ops.wkv_chunked(r, k, v, w, u))
    return saved


def sweep(cs, dev) -> dict:
    from repro_torch.kernels.sweep import ops

    # (name, d, n, trials or None)
    cases = [("d5", 5, 2000, None), ("d100", 100, 262144, None),
             ("d300", 300, 20001, None), ("b8_d100", 100, 262144, 8)]
    saved = {}
    for name, d, n, b in cases:
        gen = torch.Generator(device=dev).manual_seed(d + n)
        lead = (b,) if b else ()
        r = torch.randn(lead + (d, n), generator=gen, dtype=torch.float32, device=dev)
        scenes = [cs.spd_scene(d, gen, dev) for _ in range(b or 1)]
        m_inv, s, eta = (torch.stack(x) for x in zip(*scenes))
        if not b:
            m_inv, s, eta = m_inv[0], s[0], eta[0]
        m_inv, s = m_inv.contiguous(), s.contiguous()
        delta = 0.05 * torch.randn(lead + (n,), generator=gen, dtype=torch.float32,
                                   device=dev)
        steps = torch.tensor([0.5 ** j for j in range(16)], dtype=torch.float32,
                             device=dev) * math.sqrt(n)
        i = 37 % d
        outs = {"probe": ops.probe_sweep(r, m_inv, s, eta, i, steps)}
        for can in (True, False):
            outs[f"commit_{can}"] = ops.commit_sweep(r, m_inv, s, eta, i, delta, 1.0,
                                                     0.0, eta - 1.0, can)
            can_t = torch.full(lead or (1,), can, dtype=torch.bool, device=dev)
            outs[f"commit_t_{can}"] = ops.commit_sweep(
                r, m_inv, s, eta, i, delta, 1.0, 0.0, eta - 1.0,
                can_t if b else can_t[0])
        diag_add = 0.01 * torch.ones(lead or (), dtype=torch.float32, device=dev)
        outs["commit_split"] = ops.commit_sweep(r, m_inv, s, eta, i, delta, 0.0,
                                                diag_add, eta - 1.0, True)
        for key, val in outs.items():
            saved[f"{name}.{key}"] = list(val)
    return saved


CASES = {"attention": attention, "decode": decode, "wkv": wkv, "sweep": sweep}


def run(kernel: str, tree: str, out: str) -> None:
    sys.path.insert(0, HERE)
    import chip_smoke as cs                  # the device check of this checkout

    cs.phase_device()
    sys.path.insert(0, os.path.join(tree, "src"))
    import repro_torch
    cs.require(os.path.abspath(repro_torch.__file__).startswith(tree),
               f"imported {repro_torch.__file__}, not the tree {tree}")
    from repro_torch.kernels import _build

    _build.build_all()
    saved = CASES[kernel](cs, torch.device("cuda", 0))
    torch.save({f"{kernel}.{k}": [x.cpu() for x in v] for k, v in saved.items()}, out)
    print(f"kernel_compare: {len(saved)} {kernel} outputs of {tree} saved to {out}")


def check(a: str, b: str) -> None:
    left, right = torch.load(a), torch.load(b)
    if sorted(left) != sorted(right):
        raise SystemExit("kernel_compare: the files hold different outputs")
    differ = [k for k in left if len(left[k]) != len(right[k])
              or not all(torch.equal(x, y) for x, y in zip(left[k], right[k]))]
    if differ:
        raise SystemExit(f"kernel_compare: {len(differ)} outputs differ: {differ}")
    print(f"kernel_compare: all {len(left)} outputs equal bit for bit")


if __name__ == "__main__":
    if sys.argv[1] == "--check":
        check(sys.argv[2], sys.argv[3])
    else:
        run(sys.argv[1], os.path.abspath(sys.argv[2]), sys.argv[3])
