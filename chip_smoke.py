#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught):

  1. device   the card's name, compute capability (9.0 required) and
              `nvidia-smi --query-gpu=name,power.limit` line;
  2. build    compile the CUDA kernels of src/repro_torch/csrc with nvcc;
  3. kernels  at the deployment shapes (D=100, N=262144, K=16): each kernel
              against its plain PyTorch version on the same card inputs, with
              the stated tolerance, and timed (CUDA events around runs of 20
              launches, median of 5 runs) beside its plain version, the one
              PyTorch call that computes the same function where there is
              one, and its bound on the card;
  4. paper    `repro_torch.api.fit` on the default ExperimentSpec (Friedman-1,
              D=5, N=2000, degree-4 agents, 10 sweeps) with use_kernel=True,
              both engines, on the card and on the CPU from the same data:
              histories within 1e-4, bytes equal, every kernel of each
              engine launched exactly as often as core/icoa.py's schedule says;
  5. deploy   the same entry point at 100 agents (correlated_linear,
              n_train=262144, n_test=65536): fused 3 sweeps, incremental 1;
              eta finite and non-increasing, ledger bytes per sweep equal to
              the analytic count, launch counts as in phase 4;
  6. the kernels line, the nvidia-smi line, and the result line
     {"ok": true, "device": {...}} last.

It exits non-zero without a result when no CUDA device is present, or when
the repository's src/repro_torch is not beside it.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM peaks (NVIDIA data sheet; dense, 700 W): fp32 outside the
# tensor cores and HBM3 bandwidth.  bound_ms = max(bytes / BW, flops / FP32).
H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12

D_DEPLOY, N_DEPLOY, N_TEST_DEPLOY, K_STEPS = 100, 262144, 65536, 16
REPS, RUNS = 20, 5


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# --------------------------------------------------------------- 1. device


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"[device] {name}; compute capability {cap[0]}.{cap[1]}; "
        f"nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    require(cap == (9, 0), f"need a compute capability 9.0 card, got {cap}")
    # plain fp32 products stay full fp32 (the fp32 contract of the kernels)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] TF32 off: torch.backends.cuda.matmul.allow_tf32 = False")
    return smi


# ---------------------------------------------------------------- 2. build


def phase_build(_build) -> None:
    secs = _build.build_all()
    log(f"[build] kernels built and loaded in {secs:.1f} s")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "ptxas.log"), "w") as fh:
        fh.write(_build.build_log())
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")


# -------------------------------------------------------------- 3. kernels


_BUSY = {}


def _keep_device_busy() -> None:
    """Queue ~20 ms of matmul so that the host enqueues a whole timed run
    before the device reaches it: the events then bracket device time only,
    not the wrappers' host overhead between launches."""
    if "z" not in _BUSY:
        _BUSY["z"] = torch.randn((8192, 8192), device="cuda")
    _BUSY["z"] @ _BUSY["z"]


def time_ms(fn) -> float:
    """Device time of one call: CUDA events around a run of REPS back-to-back
    calls, divided by REPS, after 3 warm-ups; the median of RUNS such runs."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        _keep_device_busy()
        a.record()
        for _ in range(REPS):
            fn()
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / REPS)
    return statistics.median(per_call)


def bound(n_bytes: float, flops: float):
    t_bytes = n_bytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got, want, tol: float):
    """Normwise check: max |got - want| <= tol * max |want|."""
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    rel = err / scale if scale > 0 else err
    require(math.isfinite(err) and err <= tol * max(scale, 1e-30),
            f"{name}: max abs err {err:.3e} exceeds {tol:g} x {scale:.3e}")
    return err, rel


def phase_kernels(gram_ops, gram_ref, sweep_ops, sweep_ref):
    d, n, k = D_DEPLOY, N_DEPLOY, K_STEPS
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    r = torch.randn((d, n), generator=gen, device=dev)
    v = torch.randn((n,), generator=gen, device=dev)
    mm = torch.randn((d, 2 * d), generator=gen, device=dev)
    m_inv = mm @ mm.T / (2 * d) + torch.eye(d, device=dev)
    m_inv = 0.5 * (m_inv + m_inv.T)
    s = m_inv.sum(dim=1)
    eta = s.sum()
    delta = 0.05 * torch.randn((n,), generator=gen, device=dev)
    steps = torch.tensor([0.5 ** j for j in range(k)], device=dev) * math.sqrt(n)
    i = 37
    rows = []

    def record_row(name, src, replaces, errs, ms, plain_ms, lib_ms, n_bytes, flops):
        b_ms, b_by = bound(n_bytes, flops)
        row = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
               "launches": 0, "max_abs_err": max(e for e, _ in errs),
               "max_rel_err": max(r_ for _, r_ in errs), "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": lib_ms}
        log("[kernel] " + json.dumps(row))
        rows.append(row)

    # --- gram (B1): R R^T.  Least work: D(D+1)/2 distinct entries, N FMAs each.
    got, want = gram_ops.gram(r), gram_ref.gram_ref(r)
    errs = [compare("gram", got, want, 1e-5)]
    require(torch.equal(got, got.T), "gram: result not exactly symmetric")
    require(torch.equal(got, gram_ops.gram(r)), "gram: not the same bits twice")
    record_row("gram", "src/repro_torch/csrc/gram.cu",
               "src/repro/kernels/gram/kernel.py:52", errs,
               time_ms(lambda: gram_ops.gram(r)),
               time_ms(lambda: gram_ref.gram_ref(r)),
               time_ms(lambda: r @ r.T),
               4.0 * (d * n + d * d), float(d * (d + 1) * n))

    # --- row_gram (B3): R v.
    got, want = gram_ops.row_gram(v, r), gram_ref.row_gram_ref(v, r)
    errs = [compare("row_gram", got, want, 1e-5)]
    require(torch.equal(got, gram_ops.row_gram(v, r)), "row_gram: not the same bits twice")
    record_row("row_gram", "src/repro_torch/csrc/gram.cu",
               "src/repro/kernels/gram/kernel.py:120", errs,
               time_ms(lambda: gram_ops.row_gram(v, r)),
               time_ms(lambda: gram_ref.row_gram_ref(v, r)),
               time_ms(lambda: r @ v),
               4.0 * (d * n + n + d), 2.0 * d * n)

    # --- probe_sweep (B5): cross, p, ||cross||, the K-step schedule.
    got = sweep_ops.probe_sweep(r, m_inv, s, eta, i, steps)
    want = sweep_ref.probe_sweep_ref(r, m_inv, s, eta, i, steps)
    errs = [compare(f"probe_sweep.{nm}", g, w, 1e-4)
            for nm, g, w in zip(("etas", "cross", "p", "gnorm"), got, want)]
    again = sweep_ops.probe_sweep(r, m_inv, s, eta, i, steps)
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            "probe_sweep: not the same bits twice")
    record_row("probe_sweep", "src/repro_torch/csrc/sweep.cu",
               "src/repro/kernels/sweep/kernel.py:138", errs,
               time_ms(lambda: sweep_ops.probe_sweep(r, m_inv, s, eta, i, steps)),
               time_ms(lambda: sweep_ref.probe_sweep_ref(r, m_inv, s, eta, i, steps)),
               None,
               4.0 * (d * n + d * d + d + k + 1) + 4.0 * (n + k + d + 1),
               4.0 * d * n + 2.0 * d * d + 2.0 * n + 20.0 * k)

    # --- commit_sweep (B7): w = R delta / m, SMW accept probe, rank-2 update.
    errs = []
    for label, thr in (("accept", float("-inf")), ("reject", float("inf"))):
        got = sweep_ops.commit_sweep(r, m_inv, s, eta, i, delta, 1.0, 0.0, thr, True)
        want = sweep_ref.commit_sweep_ref(r, m_inv, s, eta, i, delta, 1.0, 0.0,
                                          thr, True)
        require(bool(got[3]) == bool(want[3]) == (label == "accept"),
                f"commit_sweep ({label}): accept flag {bool(got[3])}")
        for nm, g, w in zip(("m_inv", "s", "u_eff", "obj_post"),
                            (got[0], got[1], got[2], got[4]),
                            (want[0], want[1], want[2], want[4])):
            errs.append(compare(f"commit_sweep.{label}.{nm}", g, w, 1e-4))
        if label == "reject":
            require(torch.equal(got[0], m_inv) and torch.equal(got[1], s)
                    and not bool(got[2].any()),
                    "commit_sweep: a reject is not a bitwise no-op")
        else:
            require(torch.equal(got[0], got[0].T),
                    "commit_sweep: updated m_inv not exactly symmetric")
    record_row("commit_sweep", "src/repro_torch/csrc/sweep.cu",
               "src/repro/kernels/sweep/kernel.py:306", errs,
               time_ms(lambda: sweep_ops.commit_sweep(r, m_inv, s, eta, i, delta,
                                                      1.0, 0.0, eta, True)),
               time_ms(lambda: sweep_ref.commit_sweep_ref(r, m_inv, s, eta, i,
                                                          delta, 1.0, 0.0, eta, True)),
               None,
               4.0 * (d * n + n + d * d + d + 3) + 4.0 * (d * d + 2 * d + 2),
               2.0 * d * n + 2.0 * n + 12.0 * d * d)
    del r, v, mm, delta
    return rows


# ------------------------------------------------------- 4./5. main path


def expected_launches(engine: str, d: int, sweeps: int) -> dict:
    """Launches of each kernel by core/icoa.py for `sweeps` sweeps: gram at
    record 0 (weights + eta) and, per sweep, the CovState build plus the
    record; row_gram twice per agent (probe + commit) in the incremental
    engine; probe and commit once per agent in the fused engine."""
    inc = engine == "incremental"
    return {"gram": 2 + 3 * sweeps,
            "row_gram": 2 * d * sweeps if inc else 0,
            "probe_sweep": 0 if inc else d * sweeps,
            "commit_sweep": 0 if inc else d * sweeps}


def fit_on_card(api, _build, spec, data, tag: str):
    """One main-path run through api.fit on the card, its launch counts
    read just after it."""
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = api.fit(spec, device="cuda", data=data)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    d = data.xcols.shape[0]
    sweeps = len(res.history.eta) - 1
    want = expected_launches(spec.solver.engine, d, sweeps)
    log(f"[{tag}] engine={spec.solver.engine} sweeps={sweeps} fit {secs:.3f} s "
        f"launches={json.dumps(counts)} expected={json.dumps(want)}")
    require(counts == want, f"{tag}: launch counts {counts} != {want}")
    return res, counts, secs


def phase_paper(api, _build):
    totals = {}
    base = api.ExperimentSpec()
    data = base.data.build("cpu")
    for engine in ("incremental", "fused"):
        spec = api.ExperimentSpec(solver=api.SolverSpec(engine=engine,
                                                        use_kernel=True))
        res_gpu, counts, _ = fit_on_card(api, _build, spec, data, "paper")
        res_cpu = api.fit(spec, device="cpu", data=data)
        hg, hc = res_gpu.history, res_cpu.history
        require(hg.bytes_transmitted == hc.bytes_transmitted,
                f"paper {engine}: bytes differ {hg.bytes_transmitted} vs "
                f"{hc.bytes_transmitted}")
        for key in ("train_mse", "test_mse", "eta"):
            a, b = getattr(hg, key), getattr(hc, key)
            require(len(a) == len(b), f"paper {engine}: {key} lengths differ")
            worst = max(abs(x - y) / abs(y) for x, y in zip(a, b))
            require(worst <= 1e-4, f"paper {engine}: {key} differs by {worst:.2e}")
            log(f"[paper] {engine} {key}: card vs cpu max rel diff {worst:.3e}")
        log(f"[paper] {engine} final test MSE: card {hg.test_mse[-1]!r} "
            f"cpu {hc.test_mse[-1]!r}; bytes/sweep {hg.bytes_transmitted[1]!r}")
        for k_, v_ in counts.items():
            totals[k_] = totals.get(k_, 0) + v_
    return totals


def profile_sweep(icoa, res, cfg, data, engine: str) -> None:
    """torch.profiler over one deployment sweep: device busy time (sum of
    kernel durations; one stream, so they do not overlap) against the wall
    clock, the kernels that take it, and the host calls that wait on the
    device.  The full tables go to chiprun_out/profile_<engine>.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        icoa.sweep(res.family, cfg, res.params, res.f, data.xcols, data.y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    by_kernel = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_kernel.values()) / 1e3
    waits = {}
    for e in events:
        if "Synchronize" in e.name or e.name == "cudaMemcpy":
            chain, parent = [], e.cpu_parent
            while parent is not None and len(chain) < 3:
                chain.append(parent.name)
                parent = parent.cpu_parent
            key = " < ".join(chain) or "(no parent op)"
            waits[key] = waits.get(key, 0) + 1
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    log(f"[profile] {engine}: sweep wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), "
        f"{sum(1 for e in events if e.device_type == DeviceType.CUDA)} "
        f"device operations, {sum(waits.values())} host waits on the device")
    for name, us in top:
        log(f"[profile] {engine}:   {us / 1e3:8.2f} ms  {name[:90]}")
    for key, count in sorted(waits.items(), key=lambda kv: -kv[1])[:4]:
        log(f"[profile] {engine}:   {count} waits in {key[:120]}")
    prof.export_chrome_trace(os.path.join(HERE, "chiprun_out",
                                          f"trace_{engine}.json"))
    with open(os.path.join(HERE, "chiprun_out", f"profile_{engine}.txt"), "w") as fh:
        fh.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                           row_limit=40))
        fh.write("\n")
        fh.write(prof.key_averages().table(sort_by="self_device_time_total",
                                           row_limit=25))


def phase_deploy(api, _build, icoa):
    totals = {}
    dspec = api.DataSpec(source="correlated_linear", n_attrs=D_DEPLOY,
                         n_train=N_DEPLOY, n_test=N_TEST_DEPLOY)
    t0 = time.perf_counter()
    data = dspec.build("cuda")
    torch.cuda.synchronize()
    log(f"[deploy] data built and moved in {time.perf_counter() - t0:.2f} s")
    for engine, n_sweeps in (("fused", 3), ("incremental", 1)):
        spec = api.ExperimentSpec(data=dspec, solver=api.SolverSpec(
            engine=engine, use_kernel=True, n_sweeps=n_sweeps))
        torch.cuda.reset_peak_memory_stats()
        res, counts, secs = fit_on_card(api, _build, spec, data, "deploy")
        h = res.history
        require(all(math.isfinite(e) for e in h.eta), f"deploy {engine}: eta {h.eta}")
        require(all(b <= a * (1 + 1e-5) for a, b in zip(h.eta, h.eta[1:])),
                f"deploy {engine}: eta increased: {h.eta}")
        per_sweep = api.comm_floats_per_sweep(spec.solver, D_DEPLOY, N_DEPLOY) * 8
        require(h.bytes_transmitted[1:] == [float(per_sweep)] * (len(h.eta) - 1),
                f"deploy {engine}: bytes {h.bytes_transmitted} != {per_sweep}/sweep")
        # one more sweep from the fitted state, timed alone
        cfg = spec.solver.icoa_config(spec.resolved_transport())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        icoa.sweep(res.family, cfg, res.params, res.f, data.xcols, data.y)
        torch.cuda.synchronize()
        sweep_ms = (time.perf_counter() - t1) * 1e3
        profile_sweep(icoa, res, cfg, data, engine)
        log(f"[deploy] {engine}: eta {h.eta}; test_mse {h.test_mse}; "
            f"bytes/sweep {per_sweep}; fit {secs:.3f} s ({len(h.eta) - 1} "
            f"sweeps, {len(h.eta)} records); one sweep {sweep_ms:.1f} ms; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        for k_, v_ in counts.items():
            totals[k_] = totals.get(k_, 0) + v_
    return totals


def main() -> None:
    smi = phase_device()
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch import api
    from repro_torch.core import icoa
    from repro_torch.kernels import _build
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.gram import ref as gram_ref
    from repro_torch.kernels.sweep import ops as sweep_ops
    from repro_torch.kernels.sweep import ref as sweep_ref

    t_start = time.perf_counter()
    phase_build(_build)
    rows = phase_kernels(gram_ops, gram_ref, sweep_ops, sweep_ref)
    launches = phase_paper(api, _build)
    for k_, v_ in phase_deploy(api, _build, icoa).items():
        launches[k_] += v_
    for row in rows:
        row["launches"] = launches[row["name"]]
        require(row["launches"] > 0, f"{row['name']} never launched on the main path")
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
