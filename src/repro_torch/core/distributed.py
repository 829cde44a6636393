"""Distributed ICOA over a torch.distributed group: one agent a rank (twin
of repro.core.distributed's single-trial runs).

The paper's system as a collective schedule, as the JAX package builds it
under shard_map:

  * the data are ATTRIBUTE-SHARDED: rank i holds only agent i's covariate
    columns (and y); attribute data never cross the wire;
  * the only inter-agent traffic is residuals: the JAX package's
    `all_gather` of a row over the agents and its `psum` of a row masked
    to its owner (`where(me == i, x, 0)`, which delivers the owner's value
    bit for bit), here `AgentGroup.all_gather` and `AgentGroup.psum`;
  * the D x D covariance algebra is replicated: every rank runs it on the
    same gathered bytes, so every rank takes the same accept decision and
    no rank tells another what it decided.  The projection onto H_i runs
    on agent i's rank alone (the JAX package runs it everywhere and keeps
    the owner's), whose masked psum then delivers the same row.

`cfg.engine` picks the sweep body: "dense" is the paper-faithful schedule
(`_sweep_dense`: every objective evaluation rebuilds A0 from the gathered
rows, the gradient by torch.autograd; `row_broadcast` gathers once and then
moves each updated row only), "incremental" carries a core.covstate
CovState through the agent loop (`_sweep_incremental`: one gather at sweep
start, one candidate-row psum per update, rank-2 algebra), and "fused"
maps to the incremental body, as in the JAX package (its fusion lives
inside one device's agent loop), so the fused kernels do not run here.
With `use_kernel` on the card the CovState build and the record's eta are
the gram kernel (B1) and every probe and commit product the row_gram
kernel (B3), launched by every rank.  Unlike the local engine, this
backend's back-search step lives in float32 and scales with sqrt(m), the
subsample's width, as the JAX package's shard_map bodies do.

The group is gloo on the CPU and on the card alike: NCCL does not allow two
ranks on one device, and the card machine has one.  On the card each
collective stages its payload through the host (a device-to-host copy
before, host-to-device after); `AgentGroup` counts those bytes and times
every collective, staging included.

`run_distributed`, `run_averaging_distributed` and `run_refit_distributed`
run in place when the caller already is one rank of an initialised group
of D ranks (a `torchrun` launch: every rank calls them with the whole
data and keeps its own columns); otherwise `launch` starts the D ranks
itself with torch.multiprocessing (start method spawn, a FileStore in a
temporary directory: no port), hands rank i only agent i's columns, and
returns rank 0's result.  A rank's exception reaches the caller as itself
(its type and message) and ends every other rank; every group has a
finite timeout, so a rank waiting on a collective its peers never reach
fails the run.  Each rank reports its kernel launches, its final weights
and A0, its seconds per sweep and its collectives (`last_ranks()`).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import prng
from repro_torch import transport as transport_lib
from repro_torch.analysis import sanitize
from repro_torch.core import baselines, covstate, ensemble, gradient, minimax
from repro_torch.core import covariance as cov
from repro_torch.core import icoa
from repro_torch.core.tree import select, tree_map
from repro_torch.faults import inject as faults_inject
from repro_torch.kernels import _build
from repro_torch.obs import taps as obs_taps
from repro_torch.transport import Ledger, icoa_sweep_cost

__all__ = ["AgentGroup", "DEFAULT_TIMEOUT", "launch", "last_ranks",
           "run_distributed", "run_averaging_distributed",
           "run_refit_distributed"]

DEFAULT_TIMEOUT = 120.0     # seconds a rank waits on a collective

_LAST_RANKS: List[Dict[str, Any]] = []


class AgentGroup:
    """The agent axis over the process's gloo group: rank = agent id, size
    = D, and the JAX package's collectives over "agents".  Payloads on the
    card are staged through the host; `calls`, `seconds` and `staged_bytes`
    count every collective (the host copies and any wait for the device
    they imply included)."""

    def __init__(self):
        self.rank = dist.get_rank()          # the JAX package's axis_index
        self.size = dist.get_world_size()    # its psum(1)
        self.calls = 0
        self.seconds = 0.0
        self.staged_bytes = 0

    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return x.contiguous()
        self.staged_bytes += x.numel() * x.element_size()
        return x.detach().cpu().contiguous()

    def _back(self, x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if like.device.type == "cpu":
            return x
        self.staged_bytes += x.numel() * x.element_size()
        return x.to(like.device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x stacked in rank order: (D, *x.shape)."""
        t0 = time.perf_counter()
        host = self._stage(x)
        parts = [torch.empty_like(host) for _ in range(self.size)]
        dist.all_gather(parts, host)
        out = self._back(torch.stack(parts), x)
        self.calls += 1
        self.seconds += time.perf_counter() - t0
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's x (all-reduce SUM).  A payload masked to
        its owner — zeros on every other rank — arrives as the owner's
        bits."""
        t0 = time.perf_counter()
        host = self._stage(x)
        host = host.clone() if host is x else host
        dist.all_reduce(host, op=dist.ReduceOp.SUM)
        out = self._back(host, x)
        self.calls += 1
        self.seconds += time.perf_counter() - t0
        return out

    def stats(self) -> Dict[str, Any]:
        return {"calls": self.calls, "seconds": self.seconds,
                "staged_bytes": self.staged_bytes}


def last_ranks() -> List[Dict[str, Any]]:
    """The reports of the ranks of this process's last distributed run
    (every rank's after a launch, this rank's after an in-place run):
    rank, launches (kernel launches by wrapper name), seconds,
    sweep_seconds, collectives (AgentGroup.stats), and for icoa the final
    weights and A0 as numpy arrays."""
    return list(_LAST_RANKS)


# ------------------------------------------------------------ the launcher


@dataclasses.dataclass(frozen=True)
class _RankEnv:
    """The caller's torch state a spawned rank starts from."""

    dtype: torch.dtype
    allow_tf32: bool
    device: str
    timeout: float


def _error_path(tmp: str, rank: int) -> str:
    return os.path.join(tmp, f"error-{rank}.pkl")


def _save_error(tmp: str, rank: int, exc: BaseException) -> None:
    """The rank's exception, pickled for the caller to raise as itself
    (a RuntimeError carrying its traceback if it does not pickle)."""
    text = "".join(traceback.format_exception(type(exc), exc,
                                              exc.__traceback__))
    try:
        blob = pickle.dumps(exc)
        pickle.loads(blob)
    except Exception:
        blob = pickle.dumps(RuntimeError(
            f"{type(exc).__name__}: {exc}"))
    with open(_error_path(tmp, rank), "wb") as fh:
        pickle.dump((blob, text), fh)


def _rank_main(rank: int, d: int, tmp: str, env: _RankEnv, fn: Callable,
               args: Sequence[Any], own: bool) -> None:
    """One spawned rank: the caller's dtype, TF32 flag and device, one
    thread, the gloo group, then fn(group, *its own arguments, *args),
    whose return value is saved for the caller."""
    torch.set_num_threads(1)
    torch.set_default_dtype(env.dtype)
    torch.backends.cuda.matmul.allow_tf32 = env.allow_tf32
    try:
        if torch.device(env.device).type == "cuda":
            torch.cuda.set_device(0)
            _build.load_only()         # the caller built every library
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(tmp, "store"), d),
            rank=rank, world_size=d,
            timeout=datetime.timedelta(seconds=env.timeout))
        mine = (torch.load(os.path.join(tmp, f"in-{rank}.pt"), weights_only=False)
                if own else ())
        _build.reset_launches()
        out = fn(AgentGroup(), *mine, *args)
        torch.save(out, os.path.join(tmp, f"out-{rank}.pt"))
        dist.destroy_process_group()
    except BaseException as exc:
        _save_error(tmp, rank, exc)
        raise


def _raise_rank_error(tmp: str, rank: int, fallback: Exception) -> None:
    path = _error_path(tmp, rank)
    if not os.path.exists(path):
        raise fallback
    with open(path, "rb") as fh:
        blob, text = pickle.load(fh)
    exc = pickle.loads(blob)
    exc.add_note(f"raised in rank {rank} of the agent group:\n{text}")
    raise exc


def launch(fn: Callable, d: int, args: Sequence[Any] = (), *,
           per_rank: Optional[Sequence[Sequence[Any]]] = None,
           device="cpu", timeout: float = DEFAULT_TIMEOUT,
           build_kernels: bool = False) -> List[Any]:
    """Run fn(group, *per_rank[r], *args) on D spawned ranks of a gloo
    group (rank r's `group` an AgentGroup with group.rank == r) and return
    every rank's return value, in rank order.  Rank r receives per_rank[r]
    and no other rank's.

    `fn` and the arguments travel by pickle, so fn and every object they
    hold must be importable from a module (not a closure or a class of a
    test body).  Each rank starts from the caller's default dtype and TF32
    flag, runs one thread, and uses `device` (the card: cuda:0).  With
    `build_kernels` the kernel libraries are built here, before any rank
    starts; a rank only loads them.  An exception in a rank ends every
    other rank and is raised here as itself; a collective that waits
    longer than `timeout` seconds fails its rank."""
    dev = torch.device(device)
    if build_kernels and dev.type == "cuda":
        _build.build_all()
    env = _RankEnv(dtype=torch.get_default_dtype(),
                   allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                   device=str(dev), timeout=float(timeout))
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        for r, mine in enumerate(per_rank or ()):
            torch.save(tuple(mine), os.path.join(tmp, f"in-{r}.pt"))
        ctx = mp.start_processes(
            _rank_main, args=(d, tmp, env, fn, tuple(args), per_rank is not None),
            nprocs=d, join=False, start_method="spawn")
        try:
            while not ctx.join():
                pass
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as exc:
            # join() has ended every other rank: raise the first failure's
            # own exception
            _raise_rank_error(tmp, exc.error_index, exc)
        return [torch.load(os.path.join(tmp, f"out-{r}.pt"), weights_only=False)
                for r in range(d)]


def _in_place_group(d: int) -> Optional[AgentGroup]:
    """The caller's own initialised group when it has D ranks (a torchrun
    launch), None when there is none; a group of another size is an
    error."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    if dist.get_world_size() != d:
        raise ValueError(
            f"the run has {d} agents, one a rank, but this process's group "
            f"has {dist.get_world_size()} ranks")
    return AgentGroup()


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _dev(a: np.ndarray, device: str) -> torch.Tensor:
    return torch.from_numpy(a).to(device)


def _run(rank_fn: Callable, d: int, group: Optional[AgentGroup], device,
         own: Callable, shared: Sequence[Any], build_kernels: bool):
    """rank_fn(group, *own(rank), *shared) in place on the caller's
    `group`, else on D launched ranks, each given only own(rank) (and the
    shared arguments, numpy arrays moved to `device` there); rank 0's
    result comes back, every rank's report is kept for last_ranks()."""
    if group is not None:
        out, report = rank_fn(group, *own(group.rank), *shared)
        _LAST_RANKS[:] = [report]
        return out
    owns = [[_host(a) if isinstance(a, torch.Tensor) else a for a in own(r)]
            for r in range(d)]
    shared = [_host(a) if isinstance(a, torch.Tensor) else a for a in shared]
    rets = launch(_remote, d, (rank_fn, shared, str(device)), per_rank=owns,
                  device=device, build_kernels=build_kernels)
    _LAST_RANKS[:] = [report for _, report in rets]
    return _to_device(rets[0][0], device)


def _remote(group: AgentGroup, *args):
    """A launched rank: its own arguments and the shared ones, numpy
    arrays moved onto the device, then rank_fn; the result comes back
    with every tensor on the host."""
    *mine, rank_fn, shared, device = args
    mine = [_dev(a, device) if isinstance(a, np.ndarray) else a for a in mine]
    shared = [_dev(a, device) if isinstance(a, np.ndarray) else a
              for a in shared]
    out, report = rank_fn(group, *mine, *shared)
    if group.rank != 0:
        out = None
    return _to_device(out, "cpu"), report


def _to_device(obj: Any, device) -> Any:
    """Every tensor of a result (nested tuples, lists, dicts) moved to
    `device`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(v, device) for v in obj)
    return obj


def _report(group: AgentGroup, t0: float, sweep_seconds: List[float],
            **extra) -> Dict[str, Any]:
    return {"rank": group.rank, "launches": dict(_build.LAUNCHES),
            "seconds": time.perf_counter() - t0,
            "sweep_seconds": sweep_seconds, "collectives": group.stats(),
            **extra}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _gather_rows(group: AgentGroup, f_i: torch.Tensor, family, p_i,
                 xcol_test: Optional[torch.Tensor]):
    """Every agent's training predictions (D, N) and, with test columns,
    test predictions (D, N_test): one gather."""
    if xcol_test is None:
        return group.all_gather(f_i), None
    n = f_i.shape[0]
    both = group.all_gather(torch.cat([f_i, family.predict(p_i, xcol_test)]))
    return both[:, :n], both[:, n:]


def _gather_tree(group: AgentGroup, params: Any) -> Any:
    """Every agent's parameters stacked in agent order (the JAX package's
    out_specs P("agents"))."""
    return tree_map(group.all_gather, params)


# ------------------------------------------------------------ sweep bodies


def _own_key(seed: int, d: int, rank: int, device) -> torch.Tensor:
    """Agent `rank`'s init key of split(PRNGKey(seed), D)."""
    return icoa.init_keys(seed, d, device)[rank]


def _local_var(y: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """An agent's exact local variance, mean((y - f)^2): the diagonal
    scalar it sends under the Sec 4.1 split."""
    return torch.mean((y - f) ** 2)


def _masked(group: AgentGroup, owner: int, value: Optional[torch.Tensor],
            like: torch.Tensor) -> torch.Tensor:
    """psum(where(me == owner, value, 0)): the owner's value on every
    rank (non-owners pass value=None)."""
    return group.psum(value if group.rank == owner else torch.zeros_like(like))


def _subsample(cfg, key: Optional[torch.Tensor], n: int):
    """The sweep's subsample: `key, ksub = split(key)` drawn inside the
    body at alpha > 1 (the same key on every rank), else None (all n)."""
    if cfg.alpha <= 1.0:
        return None
    return cov.subsample_indices(prng.split(key)[1], n, cfg.alpha)


def _sub(x: torch.Tensor, idx: Optional[torch.Tensor]) -> torch.Tensor:
    return x if idx is None else x[..., idx]


def _project(family, p_i, xcol: torch.Tensor, f_i: torch.Tensor,
             idx: Optional[torch.Tensor], move: torch.Tensor):
    """Agent i's projection onto H_i, on its own rank and columns: its
    predictions moved by the gradient step at the transmitted positions,
    then refitted.  Returns (params, predictions)."""
    f_hat = f_i.clone()
    if idx is None:
        f_hat = f_hat + move
    else:
        f_hat[idx] = f_hat[idx] + move
    new_p = family.fit(p_i, xcol, f_hat)
    return new_p, family.predict(new_p, xcol)


def _gathered_a0(tp, f_sub_all: torch.Tensor, y_sub: torch.Tensor,
                 diag_all: torch.Tensor, alpha: float) -> torch.Tensor:
    """A0 from the gathered (possibly subsampled) rows, with the exact
    local diagonal under the split; every payload passes the codec relay
    with straight-through gradients.  A plain product: the JAX package
    builds it outside its Pallas kernel."""
    r_sub = tp.relay_rows_st(y_sub - f_sub_all)
    a0 = (r_sub @ r_sub.mT) / r_sub.shape[-1]
    if alpha > 1.0:
        diag = tp.relay_scalars_st(diag_all)
        a0 = (a0 - torch.diag_embed(torch.diagonal(a0, dim1=-2, dim2=-1))
              + torch.diag_embed(diag.expand(a0.shape[:-1])))
    return a0


def _steps(cfg, m: int, device) -> torch.Tensor:
    """The back-search schedule of this backend: float32 steps from
    cfg.step0 * sqrt(m), whatever the data dtype."""
    return icoa._step_schedule(cfg, m, torch.float32, device)


def _sweep_dense(group: AgentGroup, cfg, tp, family, xcol, y, f_i, p_i, key,
                 ledger, round_: int):
    """The paper-faithful schedule: every agent re-transmits its residual
    (and, under the split, its local variance) before every update, or with
    `row_broadcast` once a sweep and then each updated row; the gradient of
    the (protected) objective is autograd's through A0, the robust weights
    held fixed.  Returns (f_i, p_i, weights, ledger, taps, a0)."""
    d, n, me = group.size, y.shape[0], group.rank
    idx = _subsample(cfg, key, n)
    y_sub = _sub(y, idx)
    m = y_sub.shape[0]
    split = cfg.alpha > 1.0
    ledger = ledger.charge(icoa_sweep_cost(tp, m, split=split,
                                           row_wise=cfg.row_broadcast))
    steps = _steps(cfg, m, y.device)

    def eta_tilde_of(fs, diag_all):
        a0 = _gathered_a0(tp, fs, y_sub, diag_all, cfg.alpha)
        if cfg.delta > 0.0:
            a = minimax.robust_weights(a0.detach(), cfg.delta,
                                       steps=cfg.minimax_steps,
                                       lr=cfg.minimax_lr)
            return -minimax.robust_objective(a, a0, cfg.delta)
        return ensemble.eta_tilde(a0)

    def gather():
        # every agent's row and local variance, one gather
        both = group.all_gather(torch.cat([_sub(f_i, idx),
                                           _local_var(y, f_i)[None]]))
        return both[:, :m], both[:, m]

    f_cache, diag_cache = gather()
    sent = rel = None
    if cfg.obs is not None and "codec_error" in cfg.obs.taps:
        # the dense schedule re-codes every probe; the tap reports the
        # sweep-start gather's round trip
        sent = y_sub - f_cache
        rel = tp.relay_rows(sent)
    taps = icoa._sweep_taps(cfg, f_cache, sent, rel, 0, None)
    for i in range(d):
        if cfg.row_broadcast:
            f_sub_all, diag_all = f_cache, diag_cache
        else:
            f_sub_all, diag_all = gather()
        with torch.enable_grad():
            fi = f_sub_all[i].clone().requires_grad_(True)
            val = eta_tilde_of(torch.cat([f_sub_all[:i], fi[None],
                                          f_sub_all[i + 1:]]), diag_all)
            g = torch.autograd.grad(val, fi)[0]
        eta0 = val.detach()
        g_unit = g / (torch.linalg.norm(g) + 1e-30)
        cand = f_sub_all.expand(steps.shape[0], d, m).clone()
        cand[:, i] = f_sub_all[i] + steps[:, None] * g_unit
        step = icoa._first_improving(eta_tilde_of(cand, diag_all), eta0, steps)

        new_p = new_f = None
        if me == i:
            new_p, new_f = _project(family, p_i, xcol, f_i, idx, step * g_unit)
        my_sub_new = _masked(group, i, None if new_f is None else _sub(new_f, idx),
                             y_sub)
        post = f_sub_all.clone()
        post[i] = my_sub_new
        accept = eta_tilde_of(post, diag_all) > eta0
        obs_taps.tap_accept(taps, cfg.obs, i, accept)
        if me == i:
            p_i = select(accept, new_p, p_i)
            f_i = torch.where(accept, new_f, f_i)
        if cfg.row_broadcast:
            # agent i's row as it now stands (accepted or not) and its
            # variance, one masked psum
            mine = None
            if me == i:
                mine = torch.cat([_sub(f_i, idx), _local_var(y, f_i)[None]])
            both = _masked(group, i, mine, torch.zeros((m + 1,), dtype=y.dtype,
                                                       device=y.device))
            f_cache = f_cache.clone()
            diag_cache = diag_cache.clone()
            f_cache[i] = both[:m]
            diag_cache[i] = both[m]
    if cfg.row_broadcast:
        f_sub_all, diag_all = f_cache, diag_cache
    else:
        f_sub_all, diag_all = gather()
    a0 = _gathered_a0(tp, f_sub_all, y_sub, diag_all, cfg.alpha)
    if cfg.delta > 0.0:
        w = minimax.robust_weights(a0, cfg.delta, steps=cfg.minimax_steps,
                                   lr=cfg.minimax_lr)
    else:
        w = ensemble.optimal_weights(a0)
    return f_i, p_i, w, ledger, taps, a0


def _sweep_incremental(group: AgentGroup, cfg, tp, family, xcol, y, f_i, p_i,
                       key, ledger, round_: int):
    """The rank-2 CovState engine: the sweep's one full gather (residual
    rows and, under the split, the local variances) builds the CovState
    on every rank; each update moves only the candidate row and its
    variance, one masked psum, through the codec relay (and the fault
    trace's strike) into the replicated state.  Probes are O(D^2) SMW
    evaluations; the accept test holds the exact diagonal fixed and the
    commit moves it.  Budget and fault gates are settled on the host at
    sweep start from the replicated CovState and the trace, the same on
    every rank (core.icoa._schedule).  Returns (f_i, p_i, weights,
    ledger, taps, a0)."""
    d, n, me = group.size, y.shape[0], group.rank
    uk = cfg.use_kernel
    protected = cfg.delta > 0.0
    idx = _subsample(cfg, key, n)
    split = idx is not None
    y_sub = _sub(y, idx)
    m = y_sub.shape[0]
    dev = y.device

    # the engine's only full gather: the rows (and the local variances)
    if split:
        both = group.all_gather(torch.cat([_sub(f_i, idx),
                                           _local_var(y, f_i)[None]]))
        f_sub_all = both[:, :m]
    else:
        f_sub_all = group.all_gather(f_i)                 # (D, m)
    sent = y_sub - f_sub_all
    r_sub0 = tp.relay_rows(sent)
    if split:
        cs = covstate.build(r_sub0, exact_diag=tp.relay_scalars(both[:, m]),
                            use_kernel=uk)
    else:
        cs = covstate.build(r_sub0, use_kernel=uk)
    steps = _steps(cfg, m, dev)
    rt = (None if tp.faults is None
          else faults_inject.RoundTrace(tp.faults, round_, d, y.dtype))
    order, cans, agents, ledger, denied = icoa._schedule(tp, cs, ledger, m,
                                                         split, steps[0], rt)
    taps = icoa._sweep_taps(cfg, f_sub_all, sent, r_sub0, denied, rt)
    cand_like = torch.zeros((m + 1,), dtype=y.dtype, device=dev)

    def probe(state, i, u):
        if protected:
            return covstate.robust_eta_probe(state, i, u, cfg.delta,
                                             cfg.minimax_steps, cfg.minimax_lr)
        return covstate.eta_probe(state, i, u)

    for i, can_tx, agent in zip(order, cans, agents):
        if protected:
            v = minimax.robust_weights(cs.a0, cfg.delta, steps=cfg.minimax_steps,
                                       lr=cfg.minimax_lr,
                                       a_init=cs.s / torch.sum(cs.s))
            eta0 = -minimax.robust_objective(v, cs.a0, cfg.delta)
        else:
            v, eta0 = cs.s, cs.eta_tilde
        # the closed-form gradient over the transmitted positions; under
        # the split the exact diagonal is held fixed (exclude_self)
        g = gradient.cached_row_gradient(v, cs.r_sub, i, exclude_self=split)
        g_unit = g / (torch.linalg.norm(g) + 1e-30)
        p = covstate.row_product(g_unit, cs.r_sub, use_kernel=uk) / m
        u = -steps[:, None] * p[None, :]
        if split:
            u[:, i] = 0.0                  # probes hold the exact diag fixed
        else:
            u[:, i] += steps * steps / (2.0 * m)     # ||g_unit|| = 1
        step = icoa._first_improving(probe(cs, i, u), eta0, steps)

        mine = None
        if me == i:
            new_p, new_f = _project(family, p_i, xcol, f_i, idx, step * g_unit)
            mine = torch.cat([_sub(new_f, idx), _local_var(y, new_f)[None]])
        # the per-update traffic: the candidate row and its variance
        cand = _masked(group, i, mine, cand_like)
        r_cand = tp.relay_row(y_sub - cand[:m], i)
        r_cand = icoa._strike(rt, r_cand, agent)
        u_eval = covstate.row_update_vector(
            cs, i, r_cand - cs.r_sub[i],
            ddiag=torch.zeros((), dtype=y.dtype, device=dev) if split else None,
            use_kernel=uk)
        accept = probe(cs, i, u_eval) > eta0
        if can_tx is False:            # the broadcast was not made
            accept = torch.zeros_like(accept)
        obs_taps.tap_accept(taps, cfg.obs, i, accept)
        if me == i:
            p_i = select(accept, new_p, p_i)
            f_i = torch.where(accept, new_f, f_i)
        u_commit = u_eval
        if split:
            cand_diag = tp.relay_scalar(cand[m], i)
            u_commit = u_eval.clone()
            u_commit[i] = 0.5 * (cand_diag - cs.a0[i, i])
        nxt = covstate.apply_row_update(cs, i, r_cand, u_commit)
        cs = covstate.CovState(*(torch.where(accept, a, b)
                                 for a, b in zip(nxt, cs)))

    if protected:
        w = minimax.robust_weights(cs.a0, cfg.delta, steps=cfg.minimax_steps,
                                   lr=cfg.minimax_lr)
    elif rt is not None and tp.faults.crash:
        # survivors-only combination: dead agents' stale rows stay in the
        # CovState and are masked out of the served ensemble
        w = ensemble.surviving_weights(
            cs.a0, torch.tensor(rt.alive, dtype=torch.bool, device=dev))
    else:
        w = ensemble.optimal_weights(cs.a0)
    return f_i, p_i, w, ledger, taps, cs.a0


def _sweep_fn(cfg, d: int):
    """The run's transport (validated for D agents and the engine) and
    its sweep body: "fused" maps to the incremental body."""
    tp = (cfg.transport or transport_lib.default_transport(d)).validate_for(d)
    transport_lib.require_budget_engine(tp, cfg.engine)
    faults_inject.require_fault_engine(tp, cfg)
    return tp, _sweep_dense if cfg.engine == "dense" else _sweep_incremental


def _validate(cfg) -> None:
    """icoa.ICOAConfig's checks, save one: the dense body builds A0 with
    a plain product here, so use_kernel (the record's Gram) is allowed on
    the dense engine, as in the JAX package's shard_map backend."""
    if cfg.engine == "dense":
        cfg = dataclasses.replace(cfg, use_kernel=False)
    cfg.validate()


# --------------------------------------------------------------------- runs


@icoa._full_fp32
def _icoa_rank(group: AgentGroup, xcol, xcol_test, family, cfg, y, y_test,
               seed: int):
    """One rank's whole run_distributed: returns ((params, weights, hist),
    report), params stacked over the agents on every rank."""
    t0 = time.perf_counter()
    d, me, dev = group.size, group.rank, y.device
    p_i = family.fit(family.init(_own_key(seed, d, me, dev), xcol.dtype), xcol, y)
    f_i = family.predict(p_i, xcol)
    tp, body = _sweep_fn(cfg, d)
    hist = {"train_mse": [], "test_mse": [], "eta": [], "bytes": [0.0]}
    rec_obs = cfg.obs is not None and ("eta" in cfg.obs.taps
                                       or "s" in cfg.obs.taps)
    tap_rows, sweep_seconds = [], []

    def record(f_i, p_i, w):
        # the controller's view of the sweep's out_specs: every agent's
        # training and test predictions, one gather
        f, ft = _gather_rows(group, f_i, family, p_i, xcol_test)
        hist["train_mse"].append(float(torch.mean((y - w @ f) ** 2)))
        if ft is not None:
            hist["test_mse"].append(float(torch.mean((y_test - w @ ft) ** 2)))
        a0r = cov.gram(y[None, :] - f, use_kernel=cfg.use_kernel)
        eta = ensemble.eta(a0r)
        hist["eta"].append(float(eta))
        if rec_obs:
            return obs_taps.record_taps(cfg.obs, eta, ensemble.solve_vec(a0r))
        return {}

    w = torch.ones((d,), dtype=f_i.dtype, device=dev) / d
    record(f_i, p_i, w)
    key = prng.PRNGKey(seed + 1, device=dev)
    ledger = Ledger()
    a0 = None
    eta_prev = float("inf")
    with sanitize.error_scope(cfg.checks) as word:
        for r in range(cfg.n_sweeps):
            ts = time.perf_counter()
            key, k1 = prng.split(key)
            f_i, p_i, w, led2, etaps, a0 = body(group, cfg, tp, family, xcol,
                                                 y, f_i, p_i, k1, ledger,
                                                 round_=r)
            _sync(dev)
            sweep_seconds.append(time.perf_counter() - ts)
            if word is not None:
                word.throw()
            hist["bytes"].append(float(led2.spent - ledger.spent))
            ledger = led2
            rtaps = record(f_i, p_i, w)
            if cfg.obs is not None and cfg.obs.enabled:
                tap_rows.append({**etaps, **rtaps})
            if abs(eta_prev - hist["eta"][-1]) < cfg.eps:
                break
            eta_prev = hist["eta"][-1]
    hist["taps"] = obs_taps.stack_tap_rows(tap_rows)
    params = _gather_tree(group, p_i)
    report = _report(group, t0, sweep_seconds, weights=_host(w),
                     a0=None if a0 is None else _host(a0))
    return (params, w, hist), report


def run_distributed(family, cfg, xcols: torch.Tensor, y: torch.Tensor,
                    xcols_test: Optional[torch.Tensor] = None,
                    y_test: Optional[torch.Tensor] = None, seed: int = 0):
    """Full distributed ICOA run, one agent a rank; mirrors core.icoa.run's
    return contract: (params stacked over the agents, weights, hist) with
    the same history keys (train_mse, test_mse, eta, bytes, taps) and the
    same eps stop rule on successive etas.  The key discipline is the JAX
    package's shard_map run's: agent i starts from split(PRNGKey(seed),
    D)[i], then PRNGKey(seed + 1) and per sweep `key, k1 = split(key)`;
    record 0 uses uniform weights, record k the weights sweep k returns;
    the eta record is the Gram of the full residuals (the gram kernel with
    use_kernel on the card).  cfg.checks="raise" reads the check sites'
    error word after every sweep, on every rank."""
    _validate(cfg)
    d = xcols.shape[0]

    def own(r):
        return xcols[r], None if xcols_test is None else xcols_test[r]

    return _run(_icoa_rank, d, _in_place_group(d), y.device, own,
                [family, cfg, y, y_test, seed],
                cfg.use_kernel and y.device.type == "cuda")


def _averaging_rank(group: AgentGroup, xcol, family, y, seed: int):
    """Agent `rank` fits y on its own columns: no inter-agent traffic."""
    t0 = time.perf_counter()
    key = _own_key(seed, group.size, group.rank, y.device)
    p = family.fit(family.init(key, xcol.dtype), xcol, y)
    f = family.predict(p, xcol)
    out = (_gather_tree(group, p), group.all_gather(f))
    return out, _report(group, t0, [])


def run_averaging_distributed(family, xcols: torch.Tensor, y: torch.Tensor,
                              seed: int = 0):
    """Non-cooperative averaging, one agent a rank: every agent fits y on
    its own rank from split(PRNGKey(seed), D)[i].  Returns (params, f)
    stacked over the agents."""
    d = xcols.shape[0]
    return _run(_averaging_rank, d, _in_place_group(d), y.device,
                lambda r: (xcols[r],), [family, y, seed], False)


@icoa._full_fp32
def _refit_rank(group: AgentGroup, xcol, xcol_test, family, y, y_test,
                n_cycles: int, seed: int, codec, checks: str):
    """The ICEA ring, one agent a rank: each update is one psum of the
    agents' (N,) predictions; the updating agent refits the leave-me-out
    residual its codec delivers (baselines._loo_residual)."""
    t0 = time.perf_counter()
    d, me = group.size, group.rank
    key = _own_key(seed, d, me, y.device)
    p_i = family.init(key, xcol.dtype)
    f_i = torch.zeros_like(y)
    hist = {"train_mse": [], "test_mse": [], "eta": []}
    sweep_seconds = []
    with sanitize.error_scope(checks):
        for _ in range(n_cycles):
            ts = time.perf_counter()
            for i in range(d):
                f_sum = group.psum(f_i)
                if me == i:
                    residual = baselines._loo_residual(codec, y, f_sum, f_i)
                    p_i = family.fit(p_i, xcol, residual)
                    f_i = family.predict(p_i, xcol)
            _sync(y.device)
            sweep_seconds.append(time.perf_counter() - ts)
            f, ft = _gather_rows(group, f_i, family, p_i, xcol_test)
            hist["train_mse"].append(float(torch.mean((y - f.sum(dim=0)) ** 2)))
            if ft is not None:
                hist["test_mse"].append(
                    float(torch.mean((y_test - ft.sum(dim=0)) ** 2)))
            hist["eta"].append(float(ensemble.eta(cov.gram(y[None, :] - f))))
        out = (_gather_tree(group, p_i), group.all_gather(f_i), hist)
    return out, _report(group, t0, sweep_seconds)


def run_refit_distributed(family, xcols: torch.Tensor, y: torch.Tensor,
                          xcols_test: Optional[torch.Tensor] = None,
                          y_test: Optional[torch.Tensor] = None,
                          n_cycles: int = 30, seed: int = 0, codec=None,
                          checks: str = "off"):
    """Residual refitting (ICEA ring), one agent a rank: one cycle is one
    round-robin pass, each update one psum of the (N,) predictions.
    Mirrors core.baselines.residual_refitting's (params, f, hist) contract
    (params stacked over the agents; the ensemble is the sum of f).
    `codec` (transport.Codec) codes the delivered leave-me-out sum;
    `checks` is the run's sanitizer mode."""
    sanitize.validate_mode(checks, "checks")
    d = xcols.shape[0]

    def own(r):
        return xcols[r], None if xcols_test is None else xcols_test[r]

    return _run(_refit_rank, d, _in_place_group(d), y.device, own,
                [family, y, y_test, n_cycles, seed, codec, checks], False)
