"""The port's training step for the moe, hybrid, encdec and vlm families
(phi3.5-moe, Jamba, whisper-medium, qwen2-vl-7b) against the JAX package's,
on the CPU at their smoke configs, and the Mamba scan's autograd Function.

Both packages start from the same TrainState (the port's parameter draw in
the JAX package's layout and zero moments, carried across by
convert.train_state_from_numpy), with the full configs' moment dtype (bf16
for phi3.5-moe and Jamba), and take the same batches (lm_batches: the JAX
package's tokens, frames and vision embeddings): one step's loss, grad norm
and learning rate within 1e-5 relative, then two more steps' losses within
1e-4 (qwen2-vl in its config's 2 microbatches).  The state after those
steps (nonzero bf16 moments among it) crosses into the port and back into
the JAX layout bit for bit.  Remat (torch.utils.checkpoint over layer
groups, or over each enc-dec layer) gives the same bits as none, the
Mamba Function inside it too.

The selective scan under autograd is `mamba._SelectiveScan`, whose
backward is the reverse recurrence: its gradients against autograd of the
log-depth `scan` (float64 1e-12, fp32 1e-5 normwise) and, through
mamba_apply, against jax.grad of repro.models.mamba.mamba_apply (fp32
1e-5 normwise), chunked and not; its forward gives the no-grad pass's
bits; the (B, S, di, n) tensors that autograd saves for a Mamba layer,
counted with saved_tensors_hooks, are at most 4 (the level scan's
autograd saves two a level).  AdamW's update in slices gives the whole
leaf's bits.  launch.train trains each family on the CPU, with the depth
and attention period flags.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_config as jax_get_config
from repro.data.lm import lm_batches as jax_lm_batches
from repro.models import build_model as jax_build_model
from repro.models import mamba as jmamba
from repro.train import TrainState as JaxTrainState
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import RunConfig, get_config
from repro_torch.convert import lm_params_to_tree, train_state_from_numpy
from repro_torch.data.lm import lm_batches
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, mamba
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim import adamw as adamw_mod
from repro_torch.optim.clip import tree_leaves
from repro_torch.train import make_train_step

# arch -> the smoke config's overrides: the full config's moment dtype, and
# qwen2-vl's 2 microbatches
FAMILIES = {
    "phi3.5-moe-42b-a6.6b": {"moment_dtype": "bfloat16"},
    "jamba-v0.1-52b": {"moment_dtype": "bfloat16"},
    "whisper-medium": {},
    "qwen2-vl-7b": {"microbatch": 2},
}
RUN = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
SEQ, BATCH, STEPS = 32, 4, 3


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """One intra-op thread for this module: its tensors are small, and
    beside other pytest workers torch's default pool (a thread a core in
    each worker) only contends for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, **more):
    for key, want in FAMILIES[arch].items():     # the full configs' own settings
        assert getattr(get_config(arch), key) == want, (arch, key)
    over = {**FAMILIES[arch], **more}
    return (dataclasses.replace(jax_get_config(arch, smoke=True), **over),
            dataclasses.replace(get_config(arch, smoke=True), **over))


def _seq(cfg):
    return SEQ + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(cfg, jstate):
    return train_state_from_numpy(cfg, _numpy(jstate.params), _numpy(jstate.opt),
                                  np.asarray(jstate.step))


@pytest.fixture(scope="module")
def jax_runs():
    """arch -> (JAX state at init, each step's metrics, the state after
    STEPS steps), one jitted train_step per family, made on first use."""
    runs = {}

    def get(arch):
        if arch not in runs:
            jcfg, cfg = _configs(arch)
            jmodel = jax_build_model(jcfg)
            # the port's draw in the JAX layout (the JAX init is seconds of
            # dispatch or compile on one core), zero moments by the JAX AdamW
            tree = lm_params_to_tree(cfg, build_model(cfg).init(seed=0, device="cpu"))
            zeros = jax.tree.map(lambda t: np.zeros(t.shape, jnp.dtype(cfg.moment_dtype)), tree)
            state = JaxTrainState(
                params=jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree),
                opt={"mu": jax.tree.map(jnp.asarray, zeros), "nu": jax.tree.map(jnp.asarray, zeros),
                     "count": jnp.zeros((), jnp.int32)},
                step=jnp.zeros((), jnp.int32))
            step = jax.jit(jax_make_train_step(jmodel, JaxRunConfig(**RUN)))
            batches = jax_lm_batches(jmodel, seq=_seq(cfg), batch=BATCH)
            mets, s = [], state
            for _ in range(STEPS):
                s, met = step(s, next(batches))
                mets.append({k: float(v) for k, v in met.items()})
            runs[arch] = (state, mets, s)
        return runs[arch]

    return get


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_train_step_matches_jax(arch, jax_runs):
    """One step's loss, grad norm and lr within 1e-5 relative; then two more
    steps' losses within 1e-4.  The new state's dtypes are the JAX state's."""
    jstate, jmets, jfinal = jax_runs(arch)
    _, cfg = _configs(arch)
    model = build_model(cfg)
    state = _port_state(cfg, jstate)
    step = make_train_step(model, RunConfig(**RUN))
    batches = lm_batches(model, seq=_seq(cfg), batch=BATCH, device="cpu")
    for i, jmet in enumerate(jmets):
        state, met = step(state, next(batches))
        tol = 1e-5 if i == 0 else 1e-4
        for key in (("loss", "grad_norm", "lr") if i == 0 else ("loss",)):
            assert _rel(met[key], jmet[key]) <= tol, (i, key, float(met[key]), jmet[key])
    assert int(state.step) == int(jfinal.step) == STEPS and int(state.opt["count"]) == STEPS
    for part in ("mu", "nu"):
        for a, b in zip(tree_leaves(state.opt[part]), jax.tree.leaves(jfinal.opt[part])):
            assert str(a.dtype).removeprefix("torch.") == b.dtype.name == cfg.moment_dtype


_UINT = {2: np.uint16, 4: np.uint32, 8: np.uint64}
_INT = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits(x) -> np.ndarray:
    """An array's or a tensor's bits as unsigned integers (numpy has no
    bf16 arithmetic)."""
    if isinstance(x, torch.Tensor):
        return x.detach().view(_INT[x.element_size()]).numpy().view(_UINT[x.element_size()])
    x = np.asarray(x)
    return x.view(_UINT[x.dtype.itemsize])


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_train_state_crosses_and_back_bit_for_bit(arch, jax_runs):
    """The JAX state after three steps (bf16 moments for phi3.5-moe and
    Jamba, every leaf nonzero by now) into the port and back into the JAX
    layout: every parameter and moment leaf bit for bit, in its dtype."""
    _, _, jfinal = jax_runs(arch)
    _, cfg = _configs(arch)
    state = _port_state(cfg, jfinal)
    assert int(state.step) == STEPS and state.step.dtype == torch.int32
    for part, want in (("params", jfinal.params), ("mu", jfinal.opt["mu"]),
                       ("nu", jfinal.opt["nu"])):
        got = state.params if part == "params" else state.opt[part]
        back = lm_params_to_tree(cfg, got)
        w_leaves, b_leaves = jax.tree.leaves(_numpy(want)), list(tree_leaves(back))
        assert len(w_leaves) == len(b_leaves)
        for w, b in zip(w_leaves, b_leaves):
            assert str(b.dtype).removeprefix("torch.") == w.dtype.name, part
            assert np.array_equal(_bits(w), _bits(b)), part


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_remat_gives_the_same_bits(arch, jax_runs):
    """Remat on (checkpointed groups of 1 and 2 pattern repetitions; each
    enc-dec layer) against off: one step's metrics and new parameters bit
    for bit."""
    jstate, _, _ = jax_runs(arch)
    runs = []
    for remat, block in ((False, 1), (True, 1), (True, 2)):
        _, cfg = _configs(arch, remat=remat, scan_block=block)
        model = build_model(cfg)
        new, met = make_train_step(model, RunConfig(**RUN))(
            _port_state(cfg, jstate), next(lm_batches(model, seq=_seq(cfg), batch=BATCH,
                                                      device="cpu")))
        runs.append((met, list(tree_leaves(new.params))))
    (m0, p0), *others = runs
    for met, params in others:
        assert all(torch.equal(met[k], m0[k]) for k in ("loss", "grad_norm", "lr"))
        assert all(torch.equal(a, b) for a, b in zip(params, p0))


# ---------------------------------------------------------------- the scan


def _normwise(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _scan_operands(dtype, s, seed=0):
    rng = np.random.default_rng(seed)
    abar = rng.uniform(0.5, 1.0, (2, s, 3, 4))
    bx, g = rng.standard_normal((2, s, 3, 4)), rng.standard_normal((2, s, 3, 4))
    return [torch.tensor(x, dtype=dtype) for x in (abar, bx, g)]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("chunk,s", [(0, 1), (0, 13), (0, 64), (8, 16), (4, 24), (8, 12)])
def test_selective_scan_grads_match_level_scan_autograd(chunk, s, dtype, tol):
    """The Function's (dabar, dbx) against autograd of the log-depth scan
    over the whole sequence (the chunked scan computes the same function);
    its forward the no-grad pass's bits."""
    abar, bx, g = _scan_operands(dtype, s)
    leaves = [t.clone().requires_grad_(True) for t in (abar, bx)]
    h = mamba._SelectiveScan.apply(*leaves, chunk)
    assert torch.equal(h.detach(), mamba._scan_states(abar.clone(), bx.clone(), chunk))
    got = torch.autograd.grad(h, leaves, g)
    ref = [t.clone().requires_grad_(True) for t in (abar, bx)]
    want = [torch.zeros_like(t) if w is None else w for t, w in zip(ref, torch.autograd.grad(
        mamba.scan(*ref)[1], ref, g, allow_unused=True))]     # s = 1: h is bx, abar unused
    for name, a, w in zip(("dabar", "dbx"), got, want):
        assert _normwise(a, w) <= tol, name


def _mamba_setup(chunk, seed=0):
    jcfg = dataclasses.replace(jax_get_config("jamba-v0.1-52b", smoke=True), mamba_chunk=chunk)
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b", smoke=True), mamba_chunk=chunk)
    p = mamba.mamba_init(torch.Generator().manual_seed(seed), cfg)   # (jax's init: seconds)
    return jcfg, cfg, {k: jnp.asarray(v.numpy()) for k, v in p.items()}, p


@pytest.mark.parametrize("chunk,s", [(0, 11), (4, 8)])
def test_mamba_apply_grads_match_jax(chunk, s):
    """Gradients of <mamba_apply(p, x), g> with respect to every parameter
    and x, against jax.grad of the JAX package's mamba_apply: fp32 within
    1e-5 normwise, chunked and not."""
    jcfg, cfg, jp, p = _mamba_setup(chunk)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    g = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    jgp, jgx = jax.jit(jax.grad(lambda pp, xx, gg: jnp.sum(jmamba.mamba_apply(pp, xx, jcfg) * gg),
                                argnums=(0, 1)))(jp, jnp.asarray(x), jnp.asarray(g))
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out = mamba.mamba_apply(leaves, xt, cfg)
    grads = torch.autograd.grad(out, [*leaves.values(), xt], torch.from_numpy(g))
    for (name, got), want in zip([*zip(leaves, grads[:-1]), ("x", grads[-1])],
                                 [*(jgp[k] for k in leaves), jgx]):
        assert _normwise(got, want) <= 1e-5, name


def _saved_state_tensors(fn, numel):
    """How many tensors of at least half of `numel` elements (a state
    tensor, or most of one) autograd saves while fn() runs."""
    count = [0]

    def pack(t):
        count[0] += 2 * t.numel() >= numel
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return count[0]


@pytest.mark.parametrize("chunk", [0, 8])
def test_selective_scan_saves_at_most_four_state_tensors(chunk):
    """A Mamba layer under autograd saves at most four (B, S, di, n)
    tensors (exp's abar, the Function's abar and h, the output product's h:
    two storages), where the log-depth scan's autograd saves two a level;
    its output is the no-grad pass's, bit for bit."""
    _, cfg, _, p = _mamba_setup(chunk)
    b, s = 2, 64
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32))
    di, n = cfg.mamba_expand * cfg.d_model, cfg.mamba_d_state
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    out = []
    assert _saved_state_tensors(lambda: out.append(mamba.mamba_apply(leaves, x, cfg)),
                                b * s * di * n) <= 4
    assert torch.equal(out[0].detach(), mamba.mamba_apply(p, x, cfg))
    a = torch.rand((b, s, di, n), requires_grad=True)
    levels = int(np.ceil(np.log2(s)))
    assert _saved_state_tensors(lambda: mamba.scan(a, a * 1.0), b * s * di * n) >= 2 * levels


# ------------------------------------------------------------- the update


def test_adamw_update_in_slices_gives_the_leafs_bits(monkeypatch):
    """AdamW's update of a leaf above the slice size, slice by slice along
    its first axis (ragged last slice; bf16 parameters and moments), equals
    the whole leaf's update bit for bit."""
    gen = torch.Generator().manual_seed(3)
    params = {"big": torch.randn((7, 5, 3), generator=gen).to(torch.bfloat16),
              "small": torch.randn((4,), generator=gen)}
    grads = {k: torch.randn(v.shape, generator=gen).to(v.dtype) for k, v in params.items()}
    cfg = AdamWConfig(moment_dtype="bfloat16")
    state = adamw_init(params, cfg)
    state["mu"] = {k: torch.randn(v.shape, generator=gen).to(torch.bfloat16)
                   for k, v in params.items()}
    state["nu"] = {k: torch.rand(v.shape, generator=gen).to(torch.bfloat16)
                   for k, v in params.items()}
    lr = torch.tensor(1e-2)
    whole = adamw_update(grads, state, params, cfg, lr)
    monkeypatch.setattr(adamw_mod, "_SLICE", 40)          # 2 rows of 15 a slice
    sliced = adamw_update(grads, state, params, cfg, lr)
    for a, b in zip(tree_leaves([whole[0], whole[1]["mu"], whole[1]["nu"]]),
                    tree_leaves([sliced[0], sliced[1]["mu"], sliced[1]["nu"]])):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch,flags", [
    ("phi3.5-moe-42b-a6.6b", ["--layers", "1"]),
    ("jamba-v0.1-52b", ["--layers", "4", "--attn-period", "4"]),
    ("whisper-medium", []),
    ("qwen2-vl-7b", []),
])
def test_launch_train_runs_each_family_on_the_cpu(arch, flags):
    """launch.train's loop on each family's smoke config, with the depth and
    attention period cut by its flags: finite losses, the config cut."""
    seq = str(16 + get_config(arch, smoke=True).n_vision_tokens)
    model, state, log = launch_train.run(["--arch", arch, "--smoke", "--device", "cpu",
                                          "--steps", "2", "--seq", seq, "--batch", "2",
                                          *flags])
    assert len(log) == 2 and all(np.isfinite(r["loss"]) for r in log)
    assert int(state.step) == 2
    if flags:
        assert model.cfg.n_layers == int(flags[1])
    if "--attn-period" in flags:
        assert model.cfg.layer_kinds() == ["mamba", "mamba", "attn", "mamba"]
