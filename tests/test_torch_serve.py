"""repro_torch LM serving (prefill + decode) against the JAX package, on the
CPU, at the smoke configs of smollm-360m (dense, GQA), rwkv6-1.6b (ssm),
mixtral-8x22b and phi3.5-moe (moe) and jamba-v0.1-52b (hybrid: a Mamba layer,
then attention with an MoE FFN).

The JAX package's `Model.init` parameters are carried across with
`convert.lm_params_from_numpy` (no arithmetic), so both packages compute
with the same numbers in fp32.  Prefill logits, every decode_step's logits
and the caches are held to the JAX package's at 1e-4 normwise
(max |torch - jax| <= 1e-4 * max |jax|): the same fp32 function, summed in
other orders through a few layers.  Greedy generation must give the JAX
engine's tokens, and at each step the top-2 logit margin must exceed 10x
that tolerance, so that a mismatch means a fault and not a near-tie.  The
three other served dense configs (granite-3-2b: an odd vocab; qwen1.5-4b:
qkv_bias with MHA; llama3-405b: rope_theta 5e5) take the same checks.
mixtral's prompt (80 tokens) is longer than its sliding window of 64; phi3.5-moe
also runs its MoE prefill in groups of 8 tokens with tokens dropped past
capacity (capacity_factor 0.5); Jamba also with the chunked scan.  The hybrid
cache is per pattern position: every position's layers are held to the JAX
cache's `pos<p>` leaves.  `Model.loss` gives the JAX package's ce and aux.

bf16, the dtype of every full config, is held to the reference's own
bf16-vs-fp32 gap (test_bf16_serving_within_the_reference_gap).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.data.lm import MarkovStream as JaxMarkovStream
from repro.models import build_model as jax_build_model
from repro.models import transformer as jtransformer
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve.engine import _pad_cache as jax_pad_cache
from repro_torch.api import NotPortedError
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_tree
from repro_torch.data.lm import MarkovStream
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.models import transformer
from repro_torch.serve import ServeEngine, greedy_sample
from repro_torch.serve.engine import _pad_cache

TOL = 1e-4
ARCHS = ["smollm-360m", "rwkv6-1.6b", "granite-3-2b", "qwen1.5-4b", "llama3-405b",
         "mixtral-8x22b", "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b"]
MOE_ARCHS = ["mixtral-8x22b", "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b"]
N_STEPS = 6

# variants of the smoke configs that take the model's other attention and
# WKV routes: chunked attention (query blocks of 8), a sliding window of 8,
# the chunked WKV form (chunks of 8); llama3-405b also at its full config's
# rope_theta (its smoke config keeps the default 1e4) and at its full
# config's 16 query heads a KV head (the smoke config has 4)
VARIANTS = {
    "smollm-360m": [{}, {"attn_impl": "chunked", "attn_q_block": 8},
                    {"sliding_window": 8}],
    "rwkv6-1.6b": [{}, {"rwkv_chunk": 8}],
    "granite-3-2b": [{}],
    "qwen1.5-4b": [{}],
    "llama3-405b": [{}, {"rope_theta": 5e5},    # the full config's theta
                    {"n_heads": 32, "n_kv_heads": 2}],   # its 16 heads a KV head
    "mixtral-8x22b": [{}],
    "phi3.5-moe-42b-a6.6b": [{}, {"moe_group_size": 8, "capacity_factor": 0.5}],
    "jamba-v0.1-52b": [{}, {"mamba_chunk": 8}],
}
# prompt lengths other than 16: mixtral's passes its window of 64
PROMPT_LEN = {"mixtral-8x22b": 80}
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



def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1e-30)
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def _pair(arch, **overrides):
    """(JAX model, JAX params, port model, port params) of one config."""
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), **overrides)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **overrides)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, build_model(cfg), params


def _prompt(cfg, b=2, s=16, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _stack_cache(cache, jcache):
    """The port's per-layer cache as the JAX pattern layout's leaves (each
    position pos<p> stacked over its repetitions: layers p, p + period,
    ...), beside the JAX leaves."""
    period = len(jcache)
    for p in range(period):
        for name, want in jcache[f"pos{p}"].items():
            got = torch.stack([layer[name] for layer in cache[p::period]])
            yield f"pos{p}/{name}", got, want


CASES = [(a, i) for a in ARCHS for i in range(len(VARIANTS[a]))]


@pytest.mark.parametrize("arch,variant", CASES)
def test_prefill_and_decode_match_jax(arch, variant):
    jmodel, jparams, model, params = _pair(arch, **VARIANTS[arch][variant])
    toks = _prompt(model.cfg, s=PROMPT_LEN.get(arch, 16))
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(toks).long()})
    _close(logits, jlogits, TOL, "prefill logits")
    for name, got, want in _stack_cache(cache, jcache):
        _close(got, want, TOL, f"prefill cache {name}")

    s0 = toks.shape[1]
    jcache = jax_pad_cache(jcache, jmodel.cfg, s0 + N_STEPS)
    cache = _pad_cache(cache, s0 + N_STEPS)
    tok = np.asarray(jnp.argmax(jlogits, axis=-1))[:, None].astype(np.int32)
    for i in range(N_STEPS):
        jlogits, jcache = jmodel.decode_step(
            jparams, {"tokens": jnp.asarray(tok), "idx": jnp.array(s0 + i, jnp.int32)}, jcache)
        logits, cache = model.decode_step(
            params, {"tokens": torch.from_numpy(tok).long(), "idx": s0 + i}, cache)
        _close(logits, jlogits, TOL, f"decode step {i} logits")
        for name, got, want in _stack_cache(cache, jcache):
            _close(got, want, TOL, f"decode step {i} cache {name}")
        tok = np.asarray(jnp.argmax(jlogits, axis=-1))[:, None].astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax_engine(arch):
    jmodel, jparams, model, params = _pair(arch)
    toks = _prompt(model.cfg, b=3, s=12, seed=4)
    jout, _ = JaxServeEngine(jmodel).generate(jparams, {"tokens": jnp.asarray(toks)},
                                               max_new_tokens=N_STEPS)
    recorder = _MarginRecorder(model)
    out, cache = ServeEngine(recorder).generate(
        params, {"tokens": torch.from_numpy(toks).long()}, N_STEPS)
    assert out.shape == (3, N_STEPS) and len(cache) == model.cfg.n_layers
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    # every sampled decision but the discarded last one is well separated
    assert min(recorder.margins[:-1]) > 10 * TOL, recorder.margins


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


def _normwise(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_forced(jmodel, jparams, toks, forced):
    """JAX prefill logits, then one decode step per column of `forced`
    (B, K) fed those tokens; float64 numpy."""
    logits, cache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    s0 = toks.shape[1]
    cache = jax_pad_cache(cache, jmodel.cfg, s0 + forced.shape[1])
    out = [logits]
    for j in range(forced.shape[1]):
        logits, cache = jmodel.decode_step(
            jparams, {"tokens": jnp.asarray(forced[:, j:j + 1]),
                      "idx": jnp.array(s0 + j, jnp.int32)}, cache)
        out.append(logits)
    return [np.asarray(jnp.asarray(x, jnp.float32), np.float64) for x in out]


def _torch_forced(model, params, toks, forced):
    """The same for the port."""
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(toks).long()})
    s0 = toks.shape[1]
    cache = _pad_cache(cache, s0 + forced.shape[1])
    out = [logits]
    for j in range(forced.shape[1]):
        logits, cache = model.decode_step(
            params, {"tokens": torch.from_numpy(forced[:, j:j + 1]).long(), "idx": s0 + j},
            cache)
        out.append(logits)
    return [x.float().numpy().astype(np.float64) for x in out]


@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-1.6b"] + MOE_ARCHS)
def test_bf16_serving_within_the_reference_gap(arch):
    """bf16 smoke config, the port against the JAX package from the same
    bf16 parameters: prefill and 4 decode steps (both fed the JAX bf16
    engine's greedy tokens, so every step sees the same positions).  bf16
    rounds activations at other places in the two frameworks, so there is no
    tight bound to hold; the bound is the reference's own bf16 error, its
    bf16 logits against its fp32 logits from the same (upcast) parameters,
    normwise relative to max |logit|: at each step the port's bf16 logits
    lie within 2x that gap of the JAX bf16 logits.  Greedy tokens are
    compared only where they are decided: two logits can move by at most
    the bound times max |logit| each, so the argmax must agree wherever the
    JAX bf16 top-2 margin exceeds twice that."""
    jmodel, jparams, model, params = _pair(arch, **BF16)
    jmodel32 = jax_build_model(jax_get_config(arch, smoke=True))
    jparams32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), jparams)
    toks = _prompt(model.cfg, b=2, s=16, seed=5)
    forced, _ = JaxServeEngine(jmodel).generate(jparams, {"tokens": jnp.asarray(toks)},
                                                max_new_tokens=4)
    forced = np.asarray(forced).astype(np.int32)
    ref16 = _jax_forced(jmodel, jparams, toks, forced)
    ref32 = _jax_forced(jmodel32, jparams32, toks, forced)
    got = _torch_forced(model, params, toks, forced)
    decided = 0
    for k, (g, w16, w32) in enumerate(zip(got, ref16, ref32)):
        gap = _normwise(w16, w32)
        assert 0.0 < gap < 0.1, (k, gap)
        err = _normwise(g, w16)
        assert err <= 2 * gap, f"step {k}: port vs JAX bf16 {err:.3e} > 2 x gap {gap:.3e}"
        top2 = np.sort(w16, axis=-1)[:, -2:]
        margin = (top2[:, 1] - top2[:, 0]) / np.abs(w16).max()
        sure = margin > 2 * (2 * gap)
        np.testing.assert_array_equal(g.argmax(-1)[sure], w16.argmax(-1)[sure])
        decided += int(sure.sum())
    assert decided > 0


def test_greedy_sample_and_temperature():
    logits = torch.tensor([[0.1, 2.0, -1.0], [3.0, 0.0, 0.0]])
    assert greedy_sample(logits).tolist() == [1, 0]
    draws = [greedy_sample(logits, torch.Generator().manual_seed(s), temperature=5.0)
             for s in range(16)]
    assert len({tuple(d.tolist()) for d in draws}) > 1        # it samples
    again = greedy_sample(logits, torch.Generator().manual_seed(3), temperature=5.0)
    assert torch.equal(again, draws[3])                       # from its generator


@pytest.mark.parametrize("vocab,seed", [(512, 0), (49152, 3)])
def test_markov_stream_matches_jax(vocab, seed):
    got = MarkovStream(vocab, seed=seed).sample(np.random.default_rng(seed), 4, 40)
    want = JaxMarkovStream(vocab, seed=seed).sample(np.random.default_rng(seed), 4, 40)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_runs_on_cpu(arch, capsys):
    assert launch_serve.main(["--arch", arch, "--smoke", "--batch", "2",
                              "--prompt-len", "12", "--new-tokens", "4",
                              "--device", "cpu"]) == 0
    assert "generated (2, 4)" in capsys.readouterr().out
    prompt = launch_serve.build_prompt(get_config(arch, smoke=True), 2, 12)
    assert prompt["tokens"].shape == (2, 12)


def test_configs_match_jax():
    assert ARCH_IDS == JAX_ARCH_IDS
    for arch in ARCH_IDS:
        for smoke in (False, True):
            got = dataclasses.asdict(get_config(arch, smoke=smoke))
            want = dataclasses.asdict(jax_get_config(arch, smoke=smoke))
            assert got == want, arch
            cfg = get_config(arch, smoke=smoke)
            assert cfg.pdtype() == getattr(torch, cfg.param_dtype)


def test_convert_carries_bf16_params_bit_for_bit():
    """A bf16 JAX tree (the full configs' dtype) crosses as bf16 tensors with
    the same bits, stacked layers sliced per layer."""
    over = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg = dataclasses.replace(jax_get_config("smollm-360m", smoke=True), **over)
    cfg = dataclasses.replace(get_config("smollm-360m", smoke=True), **over)
    tree = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    params = lm_params_from_numpy(cfg, tree)
    wq = params["layers"][1]["mixer"]["wq"]
    assert wq.dtype == torch.bfloat16 and len(params["layers"]) == cfg.n_layers
    want = tree["blocks"]["pos0"]["mixer"]["wq"][1].astype(np.float32)
    np.testing.assert_array_equal(wq.float().numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shapes_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    shapes = transformer.cache_shapes(cfg, 8, 1088)
    jshapes = jtransformer.cache_shapes(jcfg, 8, 1088)
    period = len(jshapes)
    assert len(shapes) == cfg.n_layers
    for i, layer in enumerate(shapes):
        jlayer = jshapes[f"pos{i % period}"]
        assert set(layer) == set(jlayer), i
        for name, (jshape, jdtype) in jlayer.items():
            shape, dtype = layer[name]
            assert (cfg.n_layers // period, *shape) == tuple(jshape)
            assert str(dtype).removeprefix("torch.") == jnp.dtype(jdtype).name
    model = build_model(get_config(arch, smoke=True))
    cache = model.make_cache(dataclasses.replace(INPUT_SHAPES["decode_32k"],
                                                 seq_len=64, global_batch=2), device="cpu")
    assert all(float(t.abs().sum()) == 0.0 for layer in cache for t in layer.values())


def test_window_cache_raises():
    cfg = dataclasses.replace(get_config("smollm-360m", smoke=True),
                              sliding_window=8, window_cache=True)
    with pytest.raises(NotPortedError, match="A16"):
        build_model(cfg)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    model = build_model(get_config("smollm-360m", smoke=True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", "smollm-360m", "--smoke"])


LOSS_CASES = [(a, i) for a in MOE_ARCHS for i in range(len(VARIANTS[a]))]


@pytest.mark.parametrize("arch,variant", LOSS_CASES)
def test_loss_matches_jax(arch, variant):
    """Model.loss on a training batch: ce and aux (the MoE layers' router
    losses, non-zero here) equal the JAX package's."""
    jmodel, jparams, model, params = _pair(arch, **VARIANTS[arch][variant])
    rng = np.random.default_rng(8)
    toks = rng.integers(0, model.cfg.vocab_size, (2, 17)).astype(np.int32)
    jloss, jm = jmodel.loss(jparams, {"tokens": jnp.asarray(toks[:, :-1]),
                                      "labels": jnp.asarray(toks[:, 1:])})
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
             "labels": torch.from_numpy(toks[:, 1:]).long()}
    with torch.no_grad():
        loss, m = model.loss(params, batch)
    assert float(m["aux"]) > 0
    for name, got, want in (("loss", loss, jloss), ("ce", m["ce"], jm["ce"]),
                            ("aux", m["aux"], jm["aux"])):
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want)), (name, got, want)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_convert_round_trips_moe_and_mamba_leaves(arch):
    """A bf16 JAX tree with MoE (and Mamba) leaves crosses to the port's
    layers and back to the stacked layout bit for bit, every leaf in its
    own dtype (the router, a_log, dt_bias and d_skip fp32)."""
    over = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), **over)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    tree = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    params = lm_params_from_numpy(cfg, tree)
    moe_layers = [i for i in range(cfg.n_layers) if cfg.layer_is_moe(i)]
    assert moe_layers and params["layers"][moe_layers[0]]["ffn"]["router"].dtype == torch.float32
    back = lm_params_to_tree(cfg, params)
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(flat)
    for path, want in flat:
        t = got[path]
        assert str(t.dtype).removeprefix("torch.") == want.dtype.name, path
        if want.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), want)
