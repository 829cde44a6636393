#!/usr/bin/env python3
"""Where the WKV backward's reverse pass (csrc/wkv.cu wkv_bwd_kernel) spends
its time: build variants of csrc/wkv.cu with parts of the consumer warps'
work, or the prep warps' prep_chunk, switched off, and time each at rwkv6's
training shape (B=4, S=1024, 32 heads of 64) on the card.

    python3 tools/wkv_bwd_ablate.py

Each variant is the same source with one or more blocks wrapped in
`if (!EXP_<PART>)`, compiled by nvcc (all at once) into build/wkv_ablate/ and
called through its C entry repro_wkv_bwd on the same inputs; its outputs are
wrong wherever a part is off, only its time counts.  One line a variant:
the whole call's device ms (chip_smoke.time_ms) and its split by launch
(kernel_split, torch.profiler).  A part's cost is the base's reverse-pass ms less
the variant's, with the rest of the kernel unchanged.  Needs one CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(HERE, "src", "repro_torch", "csrc")
OUT = os.path.join(HERE, "build", "wkv_ablate")

# part -> the comment line that opens its block in wkv_bwd_kernel
BLOCKS = {
    "XYB": "      // Y = v G_end^T (warps 0, 1) or X = g S0^T and B = g v^T (warps 2, 3):",
    "DV": "      // dv's share of this block, kS G_end + A^T g",
    "G": "      // G_start = diag(Pall) G_end + (r Pex)^T g",
    "WALKS": "      // the walks of row il, tokens t = cw mod 4",
}
VARIANTS = {"base": [], "no walks": ["WALKS"], "no prep": ["PREP"], "no X, Y, B": ["XYB"],
            "no dv": ["DV"], "no G update": ["G"], "no products": ["XYB", "DV", "G"],
            "no prep, no walks": ["PREP", "WALKS"],
            "loads and syncs only": ["PREP", "XYB", "DV", "G", "WALKS"]}


def switched(src: str) -> str:
    """The source with every part behind an EXP_<PART> macro (0 by default)."""
    for part, comment in BLOCKS.items():
        at = src.index(comment)
        brace = src.index("\n      {", at)
        src = src[:brace] + f"\n      if (!EXP_{part}) {{" + src[brace + len("\n      {"):]
    call = "        prep_chunk<kI, 2>("
    assert src.count(call) == 1
    src = src.replace(call, "        if (!EXP_PREP) prep_chunk<kI, 2>(")
    macros = "".join(f"#ifndef EXP_{p}\n#define EXP_{p} 0\n#endif\n" for p in [*BLOCKS, "PREP"])
    return macros + src


def kernel_split(fn, calls: int = 5) -> dict:
    """Device ms a call of each kernel fn() launches: one torch.profiler
    recording of ten lead-in calls that are not read, then `calls` calls
    between two marker kernels (chip_smoke.profile_segments' method)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda._sleep(1000)
        for _ in range(calls):
            fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    ops = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(ops) if "spin_kernel" in e.name]
    if len(marks) != 2:
        raise SystemExit(f"wkv_bwd_ablate: {len(marks)} marker kernels in the profile")
    split = {}
    for e in ops[marks[0] + 1:marks[1]]:
        name = e.name.split("(")[0].split("<")[0].split("::")[-1].split(" ")[-1]
        split[name] = split.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    return split


def main() -> None:
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv import ops as wkv_ops

    smi = cs.phase_device()
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, "wkv_ablate.cu")
    with open(os.path.join(CSRC, "wkv.cu")) as fh:
        src = switched(fh.read())
    with open(path, "w") as fh:
        fh.write(src)
    procs = {}
    for name, parts in VARIANTS.items():
        lib = os.path.join(OUT, name.replace(",", "").replace(" ", "_") + ".so")
        cmd = [_build._nvcc(), *_build._ARCH, "-O3", "-std=c++17", "-shared", "-Xcompiler",
               "-fPIC", "-I", CSRC, *[f"-DEXP_{p}=1" for p in parts], "-o", lib, path]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0].decode()
        cs.require(proc.returncode == 0, f"{name}: nvcc failed\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(lib)

    b, s, h, dh = 4, 1024, 32, 64
    gen = torch.Generator(device="cuda").manual_seed(5)
    r, k, v, z, g = (torch.randn((b, s, h, dh), generator=gen, device="cuda") for _ in range(5))
    w = cs.wkv_decay(z, "moderate")
    u = 0.1 * torch.randn((h, dh), generator=gen, device="cuda")
    geo = wkv_ops.wkv_bwd_geometry(b, s, h, dh)
    f32 = dict(dtype=torch.float32, device="cuda")
    scratch = [torch.empty(geo[key], **f32) for key in ("states", "dv_part", "du_part")]
    outs = [torch.empty_like(r) for _ in range(4)] + [torch.empty((h, dh), **f32)]
    ptrs = [t.data_ptr() for t in (r, k, v, w, u, g, *scratch, *outs)]
    for name, lib in libs.items():
        fn = lib.repro_wkv_bwd
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def call():
            rc = fn(*ptrs, b, s, h, dh, torch.cuda.current_stream().cuda_stream)
            cs.require(rc == 0, f"{name}: launch failed ({rc})")

        print(json.dumps({"variant": name, "ms": cs.time_ms(call),
                          "split_ms": kernel_split(call), "card": smi}), flush=True)


if __name__ == "__main__":
    main()
