"""Wrappers of the fused sweep kernels (csrc/sweep.cu): `probe_sweep` and
`commit_sweep`.

Twins of repro.kernels.sweep.ops.  Numerical contract of the TPU kernels:
inputs read as fp32, fp32 accumulation, the closed-form epilogue algebra in
fp32, outputs cast back to the input dtype.  The probe kernel keeps it for
its streaming sums over N but takes ||cross||^2 and the closed form in
float64: near a pole of the step schedule the fp32 algebra alone moves an
eta by ~1e-4 of the largest (the plain version's own distance from float64
there), so the kernel is the more accurate of the two.  The TPU packing —
D padded to 128, (Dp, 8) column packs, (8, Np) row packs, the (8, 128)
parameter plate — is gone: vectors travel as (D,) and (N,), and eta /
threshold / can_tx (and the commit's diag_keep / diag_add) as one-element
device tensors or, in the commit, as Python numbers passed by value, so a
commit needs no host round trip and no fill launch.

Both take an optional leading Monte-Carlo trial axis: with r of shape
(B, D, N), every operand carries the trial axis (eta, threshold, can_tx,
diag_keep and diag_add as (B,) tensors, or one number for all trials), the
step schedule is shared, and agent i is one int for every trial or a (B,)
integer device tensor, trial b's own agent (a budget policy that orders
each trial's agents; the TPU kernels carry i per trial in their parameter
plate) — the twin of the JAX package's custom_vmap rules
(repro/kernels/sweep/ops.py).  Trial b gets the single-trial kernel's
blocks and summation order, so slice b equals the single-trial result on
its agent bit for bit.

The probe has two routes, chosen by D (`probe_route`; csrc/sweep.cu's
header has the designs): up to D = 128 the register route, one launch whose
last-arriving block per trial sums the chunks' partials and runs the closed
form; above it the shared-memory route, a (D, BN) tile per block and a
second, one-block finish launch.  `probe_geometry(d, n, batch, n_sm,
blocks_per_sm)` holds the launch shape as a pure function the CPU tests pin:
on the register route N is cut into 128-column strips and the strips into
about one wave of chunks, from (D, N) and the card only, so the batch adds
a grid dimension and nothing else.  Blocks per SM come from the kernel's
library (`probe_blocks_per_sm`, needs the card).  The 16-byte load path
runs where N % 4 == 0 and r starts on 16 bytes; else the same kernel loads 4
bytes at a time (same sums, same bits).

The commit is one launch on row_gram's stream loop (the same device code,
csrc/common.cuh): `commit_geometry(d, n, batch, n_sm, blocks_per_sm)` takes
row_gram's strips and sizes the partials;
the last-arriving block of each trial folds the strips and runs the SMW
epilogue, and writes accept straight into a torch.bool.  One kernel serves
every D (each row is its own dot product).  Blocks per SM:
`commit_blocks_per_sm` (needs the card).

A CPU tensor runs the plain version (ref.py, in fp32); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple, Union

import torch

from repro_torch.analysis import sanitize
from repro_torch.kernels import _build
from repro_torch.kernels._build import as_f32
from repro_torch.kernels.gram.ops import aligned16, row_gram_geometry
from repro_torch.kernels.sweep import ref

__all__ = ["probe_sweep", "commit_sweep", "probe_block_n", "probe_route",
           "probe_rows_per_warp", "probe_geometry", "probe_blocks_per_sm",
           "ProbeGeometry", "commit_geometry", "commit_blocks_per_sm",
           "CommitGeometry", "PROBE_REGISTER_MAX_D"]

_SMEM_FLOATS = 232448 // 4     # 227 KB: the most shared memory a block may use
PROBE_WARPS = 8                # register route: warps a block (kProbeThreads / 32)
PROBE_STRIP = 128              # columns a block takes at once, 4 a lane (kProbeStrip)
PROBE_MAX_ROWS = 16            # rows a warp holds in registers (kProbeMaxRows)
PROBE_REGISTER_MAX_D = PROBE_WARPS * PROBE_MAX_ROWS   # 128
ROUTES = ("registers", "shared")   # the kernel's route codes 0 and 1

Scalar = Union[float, torch.Tensor]


def probe_block_n(d: int) -> int:
    """Columns per block on the shared-memory route: the widest multiple of
    32 (at most 256) whose (d, bn) residual tile, cross strip, s and scratch
    fit shared memory."""
    bn = min(256, (_SMEM_FLOATS - d - 33) // (d + 1) // 32 * 32)
    if bn < 32:
        raise ValueError(
            f"probe_sweep keeps a (D, 32) residual tile in shared memory; "
            f"D={d} is too large for the kernel")
    return bn


def probe_route(d: int) -> str:
    """"registers" while each warp's rows fit its registers (D <= 128), else
    "shared"."""
    return "registers" if d <= PROBE_REGISTER_MAX_D else "shared"


def probe_rows_per_warp(d: int) -> int:
    """Rows of R a warp holds on the register route: rows w, w + 8, ..."""
    return -(-d // PROBE_WARPS)


class ProbeGeometry(NamedTuple):
    route: str                # "registers" or "shared"
    chunk: int                # columns of N a block takes
    blocks: int               # blocks a trial, ceil(n / chunk)
    grid: Tuple[int, int]     # (blocks, batch)
    part_p: int               # fp32 scratch a trial: the row partials
    part_gg: int              # fp32 scratch a trial: the ||cross||^2 partials


def probe_geometry(d: int, n: int, batch: int = 1, n_sm: int = 132,
                   blocks_per_sm: int = 2) -> ProbeGeometry:
    """The probe's launch for (d, n) and `batch` trials.  Register route:
    the fewest 128-column strips a chunk at which one wave of n_sm x
    blocks_per_sm blocks covers N, one block a chunk, partials (d, blocks
    rounded up to 4) and (blocks rounded up to 4).  Shared route: BN-column
    blocks (`probe_block_n`), partials (blocks, d) and (blocks,).  Only the
    grid's second entry depends on the batch."""
    if probe_route(d) == "registers":
        strips = -(-n // PROBE_STRIP)
        chunk = PROBE_STRIP * -(-strips // (n_sm * blocks_per_sm))
        blocks = -(-n // chunk)
        padded = -(-blocks // 4) * 4
        return ProbeGeometry("registers", chunk, blocks, (blocks, batch),
                             d * padded, padded)
    chunk = probe_block_n(d)
    blocks = -(-n // chunk)
    return ProbeGeometry("shared", chunk, blocks, (blocks, batch), blocks * d,
                         blocks)


@functools.lru_cache(maxsize=None)
def probe_blocks_per_sm(d: int) -> int:
    """Blocks of the register route's kernel for d rows that one SM holds,
    from the library's occupancy query.  Needs the card."""
    got = _build.query("sweep", "repro_probe_blocks_per_sm", d)
    if got < 1:
        raise RuntimeError(f"probe_sweep: the card holds no block of the register "
                           f"route at D={d}")
    return got


class CommitGeometry(NamedTuple):
    strip: int                # columns of N a block streams
    blocks: int               # strips a trial, ceil(n / strip)
    grid: Tuple[int, int]     # (blocks, batch)
    part: int                 # fp32 scratch a trial: (d + 1) rows of partials


def commit_geometry(d: int, n: int, batch: int = 1, n_sm: int = 132,
                    blocks_per_sm: int = 2) -> CommitGeometry:
    """The commit's launch for (d, n) and `batch` trials: row_gram's strips
    (`row_gram_geometry`, the same stream loop), one block a strip; a
    scratch row per row of R plus one for <delta, delta>, each padded to 4
    strips for 16-byte loads.  Only the grid's second entry depends on the
    batch."""
    strip, blocks = row_gram_geometry(n, n_sm, blocks_per_sm)
    padded = -(-blocks // 4) * 4
    return CommitGeometry(strip, blocks, (blocks, batch), (d + 1) * padded)


@functools.lru_cache(maxsize=None)
def commit_blocks_per_sm(d: int) -> int:
    """Blocks of the commit kernel for d rows that one SM holds, from the
    library's occupancy query.  Needs the card."""
    got = _build.query("sweep", "repro_commit_blocks_per_sm", d)
    if got < 1:
        raise RuntimeError(f"commit_sweep: the card holds no block at D={d}")
    return got


def _device_scalar(x, device: torch.device) -> torch.Tensor:
    """A one-element fp32 tensor on `device` (no host sync for a tensor
    already there; a fill kernel for a Python number)."""
    if isinstance(x, torch.Tensor):
        if x.numel() != 1:
            raise ValueError(f"expected a scalar, got shape {tuple(x.shape)}")
        if x.device != device:
            raise ValueError(f"scalar on {x.device}, kernel runs on {device}")
        return as_f32(x).reshape(1).contiguous()
    return torch.full((1,), float(x), dtype=torch.float32, device=device)


def _device_vector(x, b: int, device: torch.device) -> torch.Tensor:
    """A (b,) fp32 tensor on `device`: a (b,) tensor already there, or one
    number (a Python number or a one-element tensor) given to every trial."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"per-trial scalar on {x.device}, kernel runs on "
                             f"{device}")
        if x.numel() == 1:
            return as_f32(x).reshape(1).expand(b).contiguous()
        if tuple(x.shape) != (b,):
            raise ValueError(f"expected per-trial scalars of shape ({b},), "
                             f"got {tuple(x.shape)}")
        return as_f32(x).contiguous()
    return torch.full((b,), float(x), dtype=torch.float32, device=device)


def _plain(fn, *args):
    """The plain version standing in for a kernel on the CPU, its check
    sites off: the kernel checks nothing (analysis.sanitize)."""
    if not sanitize.checks_enabled():
        return fn(*args)
    with sanitize.sanitize_scope("off"):
        return fn(*args)


def _check_batched(op: str, r: torch.Tensor, **operands) -> None:
    """Shapes of a batched call: operand name -> its shape after (B,)."""
    if r.dim() != 3:
        raise ValueError(f"{op}: expected a (B, D, N) residual, got "
                         f"{tuple(r.shape)}")
    b = r.shape[0]
    for name, (t, tail) in operands.items():
        if tuple(t.shape) != (b, *tail):
            raise ValueError(f"{op}: expected {name} of shape {(b, *tail)}, "
                             f"got {tuple(t.shape)}")


def probe_sweep(r: torch.Tensor, m_inv: torch.Tensor, s: torch.Tensor,
                eta: Scalar, i: int, steps: torch.Tensor):
    """alpha=1 fused probe pass for agent i: one pass over r (D, N) yields
    (etas (K,), cross (N,), p (D,), gnorm ()) — the whole back-search
    schedule plus the gradient pieces (g_unit = (2 s_i / m / gnorm) * cross).
    Outputs in r's dtype.  With r (B, D, N), m_inv (B, D, D), s (B, D) and
    eta (B,): (etas (B, K), cross (B, N), p (B, D), gnorm (B,)); i may then
    be a (B,) integer tensor, trial b's agent."""
    if r.dim() == 3:
        return _probe_sweep_batched(r, m_inv, s, eta, i, steps)
    dt = r.dtype
    if _build.on_cpu(r, "probe_sweep"):
        eta32 = eta.to(torch.float32) if isinstance(eta, torch.Tensor) else eta
        out = _plain(ref.probe_sweep_ref, as_f32(r), as_f32(m_inv),
                     as_f32(s), eta32, i, as_f32(steps))
        return tuple(o.to(dt) for o in out)
    d, n = r.shape
    k = steps.shape[0]
    if not 0 <= i < d:
        raise IndexError(f"probe_sweep: agent {i} out of range for D={d}")
    _build.check_cuda_tensor("probe_sweep: r", r)
    _build.check_cuda_tensor("probe_sweep: m_inv", m_inv, (d, d))
    _build.check_cuda_tensor("probe_sweep: s", s, (d,))
    _build.check_cuda_tensor("probe_sweep: steps", steps, (k,))
    etas, cross, p, gnorm = _launch_probe(r, m_inv, s,
                                          _device_scalar(eta, r.device), i,
                                          steps, None)
    _build.LAUNCHES["probe_sweep"] += 1
    return etas.to(dt), cross.to(dt), p.to(dt), gnorm[0].to(dt)


def _agents(i, b: int, device: torch.device):
    """Agent operand of a batched launch: (i, None) for one int (the kernel
    takes it by value), (0, int32 device vector) for one agent per trial."""
    if not isinstance(i, torch.Tensor):
        return i, None
    if i.device != device or tuple(i.shape) != (b,) or i.dtype.is_floating_point:
        raise ValueError(f"per-trial agents: expected an integer ({b},) tensor on "
                         f"{device}, got {i.dtype} {tuple(i.shape)} on {i.device}")
    return 0, i.to(torch.int32).contiguous()


def _check_agent(op: str, i, d: int) -> None:
    """A shared agent index is checked on the host; a per-trial one is a
    device tensor the host does not read."""
    if not isinstance(i, torch.Tensor) and not 0 <= i < d:
        raise IndexError(f"{op}: agent {i} out of range for D={d}")


def _launch_probe(r, m_inv, s, eta, i, steps, batch):
    """The probe kernel on checked CUDA operands (eta a device tensor);
    batch None for one trial, else the trial count of r's leading axis (i
    an int, or a (batch,) tensor of agents)."""
    d, n = r.shape[-2:]
    k = steps.shape[0]
    b = batch or 1
    dev = r.device
    r32 = as_f32(r)
    bps = probe_blocks_per_sm(d) if probe_route(d) == "registers" else 1
    geo = probe_geometry(d, n, b, _build.sm_count(dev.index or 0), bps)
    lead = (batch,) if batch else ()
    f32 = dict(dtype=torch.float32, device=dev)
    cross = torch.empty(lead + (n,), **f32)
    etas = torch.empty(lead + (k,), **f32)
    p = torch.empty(lead + (d,), **f32)
    gnorm = torch.empty((b,), **f32)
    scratch = torch.empty((b * (geo.part_p + geo.part_gg),), **f32)   # the partials
    head = (r32, as_f32(m_inv), as_f32(s), eta, as_f32(steps), cross, scratch,
            _build.arrivals(dev, b), etas, p, gnorm, d, n, k)
    tail = (ROUTES.index(geo.route), geo.chunk, aligned16(n, r32))
    if batch:
        _build.launch("sweep", "repro_probe_sweep_batched", *head,
                      *_agents(i, b, dev), *tail, batch)
    else:
        _build.launch("sweep", "repro_probe_sweep", *head, i, *tail)
    return etas, cross, p, gnorm


def commit_sweep(r: torch.Tensor, m_inv: torch.Tensor, s: torch.Tensor,
                 eta: Scalar, i: int, delta: torch.Tensor, diag_keep: Scalar,
                 diag_add: Scalar, threshold: Scalar,
                 can_tx: Union[bool, torch.Tensor]):
    """Fused accept/commit for agent i after its residual row moves by delta:
    one pass over r (D, N) yields (m_inv' (D, D), s' (D,), u_eff (D,),
    accept (bool), obj_post ()) with accept/reject folded in (a reject is an
    exact no-op).  See kernels.sweep.ref.commit_sweep_ref for semantics.
    The new diagonal entry is diag_keep * (w_i + <delta, delta>/2N) +
    diag_add: 1.0 and 0.0 at alpha = 1, passed as Python numbers by value;
    under the Sec 4.1 split diag_keep = 0 and diag_add = half the exact
    diagonal's change, a device value the kernel reads without a host sync.
    With r (B, D, N), delta (B, N) and per-trial eta, threshold, can_tx and
    diag_add (B,): every output gains the leading trial axis, accept is (B,)
    bool; i may then be a (B,) integer tensor, trial b's agent."""
    if r.dim() == 3:
        return _commit_sweep_batched(r, m_inv, s, eta, i, delta, diag_keep,
                                     diag_add, threshold, can_tx)
    if _build.on_cpu(r, "commit_sweep"):
        def c32(x):
            return x.to(torch.float32) if isinstance(x, torch.Tensor) else x
        m_new, s_new, u_eff, accept, obj_post = _plain(
            ref.commit_sweep_ref, as_f32(r), as_f32(m_inv), as_f32(s), c32(eta), i,
            as_f32(delta), c32(diag_keep), c32(diag_add), c32(threshold),
            can_tx)
        return (m_new.to(m_inv.dtype), s_new.to(s.dtype), u_eff.to(s.dtype),
                accept, obj_post.to(s.dtype))
    d, n = r.shape
    if not 0 <= i < d:
        raise IndexError(f"commit_sweep: agent {i} out of range for D={d}")
    _build.check_cuda_tensor("commit_sweep: r", r)
    _build.check_cuda_tensor("commit_sweep: delta", delta, (n,))
    _build.check_cuda_tensor("commit_sweep: m_inv", m_inv, (d, d))
    _build.check_cuda_tensor("commit_sweep: s", s, (d,))
    m_new, s_new, u_eff, accept, obj_post = _launch_commit(
        r, m_inv, s, eta, i, delta, diag_keep, diag_add, threshold, can_tx, None)
    _build.LAUNCHES["commit_sweep"] += 1
    return (m_new.to(m_inv.dtype), s_new.to(s.dtype), u_eff.to(s.dtype),
            accept[0], obj_post[0].to(s.dtype))


def _by_value_or_tensor(x, b: int, device: torch.device, batched: bool):
    """A scalar operand of the commit kernel as (pointer, value): a Python
    number goes by value (no fill launch), a tensor as a device vector of
    the kernel's trials, which the kernel reads."""
    if isinstance(x, torch.Tensor):
        return (_device_vector(x, b, device) if batched
                else _device_scalar(x, device)), 0.0
    return None, float(x)


def _launch_commit(r, m_inv, s, eta, i, delta, diag_keep, diag_add, threshold,
                   can_tx, batch):
    """The commit kernel on checked CUDA operands; batch None for one
    trial, else the trial count of r's leading axis.  Returns fp32 m_inv',
    s', u_eff, accept (b,) bool and obj_post (b,)."""
    d, n = r.shape[-2:]
    b = batch or 1
    dev = r.device
    r32, d32 = as_f32(r), as_f32(delta)
    geo = commit_geometry(d, n, b, _build.sm_count(dev.index or 0),
                          commit_blocks_per_sm(d))
    lead = (batch,) if batch else ()
    f32 = dict(dtype=torch.float32, device=dev)
    m_new = torch.empty(lead + (d, d), **f32)
    s_new = torch.empty(lead + (d,), **f32)
    u_eff = torch.empty(lead + (d,), **f32)
    accept = torch.empty((b,), dtype=torch.bool, device=dev)
    obj_post = torch.empty((b,), **f32)
    scratch = torch.empty((b * geo.part,), **f32)   # the strips' partials
    batched = batch is not None
    can_ptr, can_val = _by_value_or_tensor(can_tx, b, dev, batched)
    head = (r32, d32, as_f32(m_inv), as_f32(s),
            *_by_value_or_tensor(eta, b, dev, batched),
            *_by_value_or_tensor(threshold, b, dev, batched),
            can_ptr, int(can_val != 0.0), scratch, _build.arrivals(dev, b), m_new,
            s_new, u_eff, accept, obj_post, d, n)
    tail = (*_by_value_or_tensor(diag_keep, b, dev, batched),
            *_by_value_or_tensor(diag_add, b, dev, batched),
            geo.strip, aligned16(n, r32, d32))
    if batched:
        _build.launch("sweep", "repro_commit_sweep_batched", *head,
                      *_agents(i, b, dev), *tail, batch)
    else:
        _build.launch("sweep", "repro_commit_sweep", *head, i, *tail)
    return m_new, s_new, u_eff, accept, obj_post


def _probe_sweep_batched(r, m_inv, s, eta, i, steps):
    dt = r.dtype
    b, d, n = r.shape
    k = steps.shape[0]
    _check_batched("probe_sweep", r, m_inv=(m_inv, (d, d)), s=(s, (d,)))
    _check_agent("probe_sweep", i, d)
    if _build.on_cpu(r, "probe_sweep"):
        eta32 = eta.to(torch.float32) if isinstance(eta, torch.Tensor) else eta
        out = _plain(ref.probe_sweep_batched_ref, as_f32(r), as_f32(m_inv),
                     as_f32(s), eta32, i, as_f32(steps))
        return tuple(o.to(dt) for o in out)
    _build.check_cuda_tensor("probe_sweep: r", r)
    _build.check_cuda_tensor("probe_sweep: m_inv", m_inv)
    _build.check_cuda_tensor("probe_sweep: s", s)
    _build.check_cuda_tensor("probe_sweep: steps", steps, (k,))
    etas, cross, p, gnorm = _launch_probe(r, m_inv, s,
                                          _device_vector(eta, b, r.device), i,
                                          steps, b)
    _build.LAUNCHES["probe_sweep_batched"] += 1
    if isinstance(i, torch.Tensor):
        _build.LAUNCHES["probe_sweep_batched_per_trial"] += 1
    return etas.to(dt), cross.to(dt), p.to(dt), gnorm.to(dt)


def _commit_sweep_batched(r, m_inv, s, eta, i, delta, diag_keep, diag_add,
                          threshold, can_tx):
    b, d, n = r.shape
    _check_batched("commit_sweep", r, m_inv=(m_inv, (d, d)), s=(s, (d,)),
                   delta=(delta, (n,)))
    _check_agent("commit_sweep", i, d)
    if _build.on_cpu(r, "commit_sweep"):
        def c32(x):
            return x.to(torch.float32) if isinstance(x, torch.Tensor) else x
        m_new, s_new, u_eff, accept, obj_post = _plain(
            ref.commit_sweep_batched_ref, as_f32(r), as_f32(m_inv), as_f32(s),
            c32(eta), i, as_f32(delta),
            c32(diag_keep), c32(diag_add), c32(threshold), can_tx)
        return (m_new.to(m_inv.dtype), s_new.to(s.dtype), u_eff.to(s.dtype),
                accept, obj_post.to(s.dtype))
    _build.check_cuda_tensor("commit_sweep: r", r)
    _build.check_cuda_tensor("commit_sweep: delta", delta)
    _build.check_cuda_tensor("commit_sweep: m_inv", m_inv)
    _build.check_cuda_tensor("commit_sweep: s", s)
    m_new, s_new, u_eff, accept, obj_post = _launch_commit(
        r, m_inv, s, eta, i, delta, diag_keep, diag_add, threshold, can_tx, b)
    _build.LAUNCHES["commit_sweep_batched"] += 1
    if isinstance(i, torch.Tensor):
        _build.LAUNCHES["commit_sweep_batched_per_trial"] += 1
    return (m_new.to(m_inv.dtype), s_new.to(s.dtype), u_eff.to(s.dtype),
            accept, obj_post.to(s.dtype))
