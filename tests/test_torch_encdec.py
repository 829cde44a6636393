"""repro_torch's enc-dec family (models/encdec.py, whisper-medium) against the
JAX package, on the CPU, at whisper-medium's smoke config (2 + 2 layers,
d 256, 4 heads of 64, 50 frames).

The JAX package's `Model.init` parameters are carried across with
`convert.lm_params_from_numpy` (no arithmetic), frames and prompts come
from seeded numpy draws, and fp32 results are held at 1e-4 normwise (max
|torch - jax| <= 1e-4 * max |jax|): the encoder output, the training
logits, the prefill logits, every decode step's logits, and the self and
cross caches after each.  Greedy generation gives the JAX engine's tokens,
with every decided step's top-2 margin above 10x the tolerance.  The MLPs
are jax.nn.gelu's tanh approximation (torch's default erf form would miss
the tolerance, as test_gelu_mlp_is_the_tanh_form shows), and the
sinusoidal positions are fp32.  bf16 is held to the reference's own
bf16-vs-fp32 gap.  The JAX side is compiled once per module (jitted
prefill and decode in module-scoped fixtures).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_get_config
from repro.data.lm import lm_batches as jax_lm_batches
from repro.models import build_model as jax_build_model
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve.engine import _pad_cache as jax_pad_cache
from repro_torch.configs import INPUT_SHAPES, RunConfig, get_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_tree
from repro_torch.data.lm import lm_batches
from repro_torch.kernels.flash_decode.ref import decode_ref
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, encdec
from repro_torch.models import layers as L
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.clip import tree_leaves
from repro_torch.serve import ServeEngine
from repro_torch.serve.engine import _pad_cache
from repro_torch.train import make_train_step
from repro_torch.train.step import TrainState

ARCH = "whisper-medium"
TOL = 1e-4
N_STEPS = 5
GEN_SEED = 7     # a prompt whose greedy steps are all decided by a clear margin
BF16 = {"param_dtype": "bfloat16", "compute_dtype": "bfloat16"}


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """One intra-op thread for this module: its tensors are small, and
    beside other pytest workers torch's default pool (a thread a core in
    each worker) only contends for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _normwise(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _close(got, want, tol, what=""):
    err = _normwise(got, want)
    assert err <= tol, f"{what}: {err:.3e} > {tol}"


class _Pair:
    """The JAX model and engine (whose jitted prefill and decode every test
    here calls, at one prompt shape, so that each compiles once), its
    parameters, and the port's model and the same parameters."""

    def __init__(self, **overrides):
        jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), **overrides)
        cfg = dataclasses.replace(get_config(ARCH, smoke=True), **overrides)
        self.jmodel = jax_build_model(jcfg)
        self.jparams = self.jmodel.init(jax.random.PRNGKey(0))
        self.tree = jax.tree.map(np.asarray, self.jparams)
        self.model = build_model(cfg)
        self.params = lm_params_from_numpy(cfg, self.tree)
        self.engine = JaxServeEngine(self.jmodel)
        self.jprefill, self.jdecode = self.engine._prefill, self.engine._decode


@pytest.fixture(scope="module")
def fp32():
    return _Pair()


@pytest.fixture(scope="module")
def bf16():
    return _Pair(**BF16)


def _inputs(cfg, b=2, s=12, seed=1):
    """(tokens (B, S) int32, frames (B, n_frames, D) float32), seeded."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    frames = rng.standard_normal((b, cfg.n_frames, cfg.d_model), dtype=np.float32)
    return toks, frames


def _batches(toks, frames, cdtype=torch.float32):
    jb = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "frames": torch.from_numpy(frames).to(cdtype)}
    return jb, tb


def _stacked(cache, name):
    return torch.stack([layer[name] for layer in cache]).float().numpy()


# ----------------------------------------------------------------- layers


def test_gelu_mlp_is_the_tanh_form():
    """gelu_mlp equals the JAX package's (jax.nn.gelu: the tanh form) at
    1e-6; torch's default erf form is more than 1e-4 away from it on
    [-6, 6], element by element."""
    grid = np.linspace(-6, 6, 4001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(grid)), np.float64)
    assert np.abs(F.gelu(torch.from_numpy(grid)).numpy() - want).max() > 1e-4
    assert np.abs(F.gelu(torch.from_numpy(grid), approximate="tanh").numpy()
                  - want).max() < 1e-6
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 64), dtype=np.float32) * 3
    p = {"wi": rng.standard_normal((64, 96), dtype=np.float32) * 0.5,
         "wo": rng.standard_normal((96, 64), dtype=np.float32) * 0.1}
    want = np.asarray(jlayers.gelu_mlp({k: jnp.asarray(v) for k, v in p.items()},
                                       jnp.asarray(x)))
    got = L.gelu_mlp({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    _close(got, want, 1e-6, "gelu_mlp")
    init = L.gelu_mlp_init(torch.Generator().manual_seed(0), 8, 32, torch.float32)
    assert {k: tuple(v.shape) for k, v in init.items()} == {"wi": (8, 32), "wo": (32, 8)}


@pytest.mark.parametrize("s,d", [(50, 256), (448, 1024), (1500, 1024)])
def test_sinusoidal_positions_match_jax(s, d):
    """fp32 [sin | cos] tables equal the JAX package's within 1e-4 normwise,
    and within one ulp of the largest angle at 1500 positions: XLA's fp32
    exp is not torch's (56 of whisper's 512 frequencies are one ulp apart;
    the angles' arguments are equal bit for bit), so an angle p * f can round
    one ulp apart, 2^-13 = 1.22e-4 at p ~ 1374."""
    want = np.asarray(jlayers.sinusoidal_positions(s, d))
    got = L.sinusoidal_positions(s, d, "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (s, d)
    _close(got, want, max(TOL, float(np.spacing(np.float32(s - 1)))) + 1e-6, "positions")
    # [sin | cos] halves, not interleaved: row 0 is zeros then ones
    assert torch.equal(got[0], torch.cat([torch.zeros(d // 2), torch.ones(d // 2)]))


def test_cross_decode_route_is_exact():
    """One non-causal query token (cross-attention decode) goes on the card
    to B10 at idx = Skv - 1 with no window: B10's plain version there equals
    the non-causal plain attention, which attends to every key."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn((2, 1, 4, 64), generator=gen, dtype=torch.float32)
    k = torch.randn((2, 50, 4, 64), generator=gen, dtype=torch.float32)
    v = torch.randn((2, 50, 4, 64), generator=gen, dtype=torch.float32)
    want = L.attention_scores(q, k, v, causal=False)
    got = decode_ref(q[:, 0], k, v, k.shape[1] - 1)[:, None]
    _close(got, want, 1e-6, "cross decode")
    # and it is not the causal call at position 0
    assert _normwise(L.attention_scores(q, k, v, causal=True), want) > 0.1


# ----------------------------------------------------------------- model


def test_encode_forward_and_loss_match_jax(fp32):
    """The encoder output, the training logits (aux 0) and Model.loss's ce
    (one jitted JAX call computes all three)."""
    cfg, jcfg = fp32.model.cfg, fp32.jmodel.cfg
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    frames = rng.standard_normal((2, cfg.n_frames, cfg.d_model), dtype=np.float32)
    jb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(toks[:, :-1]).long(),
          "labels": torch.from_numpy(toks[:, 1:]).long()}

    @jax.jit
    def jax_all(p, b):
        return (jencdec.encode(p, b["frames"], jcfg), fp32.jmodel.forward(p, b),
                fp32.jmodel.loss(p, b))

    jenc, (jlogits, jaux), (jloss, jm) = jax_all(fp32.jparams, jb)
    with torch.no_grad():
        _close(encdec.encode(fp32.params, tb["frames"], cfg), jenc, TOL, "encoder output")
        logits, aux = fp32.model.forward(fp32.params, tb)
        loss, m = fp32.model.loss(fp32.params, tb)
    _close(logits, jlogits, TOL, "forward logits")
    assert aux.dtype == torch.float32 and float(aux) == float(jaux) == 0.0
    assert float(m["aux"]) == float(jm["aux"]) == 0.0
    for got, want in ((loss, jloss), (m["ce"], jm["ce"])):
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want)), (got, want)


def test_prefill_and_decode_match_jax(fp32):
    """Prefill logits and caches, then N_STEPS decode steps fed the JAX
    greedy token: logits and the self and cross caches after each."""
    cfg = fp32.model.cfg
    toks, frames = _inputs(cfg, s=12, seed=2)
    jb, tb = _batches(toks, frames)
    jlogits, jcache = fp32.jprefill(fp32.jparams, jb)
    logits, cache = fp32.model.prefill(fp32.params, tb)
    _close(logits, jlogits, TOL, "prefill logits")
    assert sorted(cache[0]) == sorted(jcache) == ["cross_k", "cross_v", "self_k", "self_v"]
    for name in jcache:
        _close(_stacked(cache, name), jcache[name], TOL, f"prefill {name}")
    assert all(c["cross_k"].is_contiguous() for c in cache)

    s0 = toks.shape[1]
    jcache = jax_pad_cache(jcache, fp32.jmodel.cfg, s0 + N_STEPS)
    cache = _pad_cache(cache, s0 + N_STEPS)
    assert cache[0]["self_k"].shape[1] == s0 + N_STEPS
    assert cache[0]["cross_k"].shape[1] == cfg.n_frames            # never padded
    tok = np.asarray(jnp.argmax(jlogits, axis=-1))[:, None].astype(np.int32)
    for i in range(N_STEPS):
        jlogits, jcache = fp32.jdecode(
            fp32.jparams, {"tokens": jnp.asarray(tok), "idx": jnp.array(s0 + i, jnp.int32)},
            jcache)
        logits, cache = fp32.model.decode_step(
            fp32.params, {"tokens": torch.from_numpy(tok).long(), "idx": s0 + i}, cache)
        _close(logits, jlogits, TOL, f"decode step {i} logits")
        for name in jcache:
            _close(_stacked(cache, name), jcache[name], TOL, f"decode step {i} {name}")
        tok = np.asarray(jnp.argmax(jlogits, axis=-1))[:, None].astype(np.int32)


class _MarginRecorder:
    """The model, recording each decode step's top-2 logit margin relative
    to its largest |logit|."""

    def __init__(self, model):
        self.model, self.cfg, self.margins = model, model.cfg, []

    def prefill(self, p, batch):
        return self.model.prefill(p, batch)

    def decode_step(self, p, batch, cache):
        logits, cache = self.model.decode_step(p, batch, cache)
        top2 = torch.topk(logits, 2, dim=-1).values
        self.margins.append(float((top2[:, 0] - top2[:, 1]).min() / logits.abs().max()))
        return logits, cache


def test_generate_matches_jax_engine(fp32):
    cfg = fp32.model.cfg
    toks, frames = _inputs(cfg, s=12, seed=GEN_SEED)
    jb, tb = _batches(toks, frames)
    jout, _ = fp32.engine.generate(fp32.jparams, jb, max_new_tokens=N_STEPS)
    recorder = _MarginRecorder(fp32.model)
    out, cache = ServeEngine(recorder).generate(fp32.params, tb, N_STEPS)
    assert out.shape == (2, N_STEPS) and len(cache) == cfg.n_layers
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert min(recorder.margins[:-1]) > 10 * TOL, recorder.margins


def _jax_forced(pair, params, batch, forced):
    """JAX prefill logits, then one decode step per column of `forced`
    (B, K) fed those tokens; float64 numpy."""
    logits, cache = pair.jprefill(params, batch)
    s0 = batch["tokens"].shape[1]
    cache = jax_pad_cache(cache, pair.jmodel.cfg, s0 + forced.shape[1])
    out = [logits]
    for j in range(forced.shape[1]):
        logits, cache = pair.jdecode(params, {"tokens": jnp.asarray(forced[:, j:j + 1]),
                                              "idx": jnp.array(s0 + j, jnp.int32)}, cache)
        out.append(logits)
    return [np.asarray(jnp.asarray(x, jnp.float32), np.float64) for x in out]


def _torch_forced(model, params, batch, forced):
    """The same for the port."""
    logits, cache = model.prefill(params, batch)
    s0 = batch["tokens"].shape[1]
    cache = _pad_cache(cache, s0 + forced.shape[1])
    out = [logits]
    for j in range(forced.shape[1]):
        logits, cache = model.decode_step(
            params, {"tokens": torch.from_numpy(forced[:, j:j + 1]).long(), "idx": s0 + j},
            cache)
        out.append(logits)
    return [x.float().numpy().astype(np.float64) for x in out]


def test_bf16_serving_within_the_reference_gap(fp32, bf16):
    """bf16 smoke config from the same bf16 parameters: prefill and 5
    decode steps fed the JAX bf16 engine's greedy tokens.  At each step the
    port's bf16 logits lie within 2x the reference's own bf16-vs-fp32 gap
    (its bf16 logits against its fp32 logits from the upcast parameters) of
    the JAX bf16 logits, and the argmax agrees wherever the JAX bf16 top-2
    margin exceeds twice that bound."""
    cfg = bf16.model.cfg
    toks, frames = _inputs(cfg, s=12, seed=5)
    jb16 = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames, jnp.bfloat16)}
    jb32 = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    forced, _ = bf16.engine.generate(bf16.jparams, jb16, max_new_tokens=N_STEPS)
    forced = np.asarray(forced).astype(np.int32)
    jparams32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), bf16.jparams)
    ref16 = _jax_forced(bf16, bf16.jparams, jb16, forced)
    ref32 = _jax_forced(fp32, jparams32, jb32, forced)
    got = _torch_forced(bf16.model, bf16.params, _batches(toks, frames, torch.bfloat16)[1],
                        forced)
    decided = 0
    for k, (g, w16, w32) in enumerate(zip(got, ref16, ref32)):
        gap = _normwise(w16, w32)
        assert 0.0 < gap < 0.1, (k, gap)
        err = _normwise(g, w16)
        assert err <= 2 * gap, f"step {k}: port vs JAX bf16 {err:.3e} > 2 x gap {gap:.3e}"
        top2 = np.sort(w16, axis=-1)[:, -2:]
        sure = (top2[:, 1] - top2[:, 0]) / np.abs(w16).max() > 2 * (2 * gap)
        np.testing.assert_array_equal(g.argmax(-1)[sure], w16.argmax(-1)[sure])
        decided += int(sure.sum())
    assert decided > 0


# ------------------------------------------------- specs, data, convert


def test_cache_shapes_and_specs_match_jax():
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    shapes = encdec.cache_shapes(cfg, 8, 448)
    jshapes = jencdec.cache_shapes(jcfg, 8, 448)
    assert len(shapes) == cfg.n_layers == 24
    for name, (jshape, jdtype) in jshapes.items():
        for layer in shapes:
            shape, dtype = layer[name]
            assert (cfg.n_layers, *shape) == tuple(jshape)
            assert str(dtype).removeprefix("torch.") == jnp.dtype(jdtype).name
    model = build_model(get_config(ARCH, smoke=True))
    cache = model.make_cache(dataclasses.replace(INPUT_SHAPES["decode_32k"], seq_len=64,
                                                 global_batch=2), device="cpu")
    assert [tuple(c["self_k"].shape) for c in cache] == [(2, 64, 4, 64)] * 2
    assert [tuple(c["cross_v"].shape) for c in cache] == [(2, 50, 4, 64)] * 2


@pytest.mark.parametrize("over", [{}, BF16])
def test_lm_batches_match_jax(over):
    """frames (the float32 normals cast to the compute dtype), tokens and
    labels equal the JAX package's, bit for bit."""
    jmodel = jax_build_model(dataclasses.replace(jax_get_config(ARCH, smoke=True), **over))
    model = build_model(dataclasses.replace(get_config(ARCH, smoke=True), **over))
    jit = jax_lm_batches(jmodel, seq=20, batch=3, seed=3)
    it = lm_batches(model, seq=20, batch=3, seed=3, device="cpu")
    for _ in range(2):
        jb, b = next(jit), next(it)
        assert sorted(b) == sorted(jb) == ["frames", "labels", "tokens"]
        assert b["frames"].dtype == model.cfg.cdtype() and b["frames"].shape == (3, 50, 256)
        np.testing.assert_array_equal(b["frames"].float().numpy(),
                                      np.asarray(jb["frames"], np.float32))
        for key in ("tokens", "labels"):
            assert b[key].dtype == torch.int64 and b[key].shape == (3, 20)
            np.testing.assert_array_equal(b[key].numpy(), np.asarray(jb[key]))


def test_convert_round_trips_bit_for_bit():
    """A bf16 JAX tree (enc_layers, dec_layers stacked over their layers)
    crosses to the port's per-layer lists and back bit for bit, and so does
    a TrainState."""
    from repro.configs import RunConfig as JaxRunConfig
    from repro.train import init_state as jax_init_state
    from repro_torch.convert import train_state_from_numpy

    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), **BF16)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), **BF16)
    jstate = jax_init_state(jax_build_model(jcfg), jax.random.PRNGKey(0), JaxRunConfig())
    tree = jax.tree.map(np.asarray, jstate.params)
    params = lm_params_from_numpy(cfg, tree)
    assert len(params["enc_layers"]) == cfg.n_enc_layers
    assert len(params["dec_layers"]) == cfg.n_layers
    np.testing.assert_array_equal(
        params["dec_layers"][1]["cross_attn"]["wk"].view(torch.int16).numpy(),
        tree["dec_layers"]["cross_attn"]["wk"][1].view(np.int16))
    back = lm_params_to_tree(cfg, params)
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(flat)
    for path, want in flat:
        assert got[path].dtype == torch.bfloat16, path
        np.testing.assert_array_equal(got[path].view(torch.int16).numpy(), want.view(np.int16))
    state = train_state_from_numpy(cfg, tree, jax.tree.map(np.asarray, jstate.opt),
                                   np.asarray(jstate.step))
    assert isinstance(state, TrainState) and int(state.step) == 0
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state.params),
                                                 tree_leaves(params)))


def test_remat_gives_the_same_bits():
    """One train step with each layer under a checkpoint (cfg.remat) and
    without: loss, grad norm and the new parameters bit for bit."""
    runs = []
    for remat in (False, True):
        model = build_model(dataclasses.replace(get_config(ARCH, smoke=True), remat=remat))
        params = model.init(seed=0, device="cpu")
        state = TrainState(params=params, opt=adamw_init(params, AdamWConfig()),
                           step=torch.zeros((), dtype=torch.int32))
        new, met = make_train_step(model, RunConfig(learning_rate=1e-3))(
            state, next(lm_batches(model, seq=16, batch=2, device="cpu")))
        runs.append((met, list(tree_leaves(new.params))))
    (m0, p0), (m1, p1) = runs
    assert all(torch.equal(m0[k], m1[k]) for k in ("loss", "grad_norm", "lr"))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_launchers_run_on_cpu(capsys):
    assert launch_serve.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "12",
                              "--new-tokens", "4", "--device", "cpu"]) == 0
    assert "generated (2, 4)" in capsys.readouterr().out
    prompt = launch_serve.build_prompt(get_config(ARCH, smoke=True), 2, 12)
    assert sorted(prompt) == ["frames", "tokens"] and prompt["tokens"].shape == (2, 12)
    assert prompt["frames"].shape == (2, 50, 256) and not prompt["frames"].any()
    assert launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                              "--seq", "16", "--batch", "2"]) == 0
    assert "step    1 loss" in capsys.readouterr().out
