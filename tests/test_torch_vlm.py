"""repro_torch's vlm family (Qwen2-VL's language path: vision_proj, the vision
prefix, M-RoPE, qkv bias) against the JAX package, on the CPU, at
qwen2-vl-7b's smoke config (2 layers, d 256, 4/2 heads of 64, 16 vision
tokens, M-RoPE sections (16, 8, 8)).

The JAX package's parameters are carried across with
`convert.lm_params_from_numpy` (no arithmetic), the vision embeddings and
prompts come from seeded numpy draws, and fp32 results are held at 1e-4
normwise (max |torch - jax| <= 1e-4 * max |jax|): the training logits over
the vision prefix and the text, the prefill logits and cache, and every
decode step's logits and cache.  Greedy generation gives the JAX engine's
tokens, with every decided step's top-2 margin above 10x the tolerance, and
`Model.loss` (which drops the vision prefix) the JAX package's ce.  bf16 is
held to the reference's own bf16-vs-fp32 gap.  The serving engine keeps the
reference's decode positions (ROADMAP C9, pinned below).  The JAX side is
compiled once per module (jitted prefill and decode in module-scoped
fixtures).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.lm import lm_batches as jax_lm_batches
from repro.models import build_model as jax_build_model
from repro.models import layers as jlayers
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve.engine import _pad_cache as jax_pad_cache
from repro.train.step import _microbatches as jax_microbatches
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_tree
from repro_torch.data.lm import lm_batches
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.serve import ServeEngine
from repro_torch.serve.engine import _pad_cache
from repro_torch.train.step import _microbatches

ARCH = "qwen2-vl-7b"
TOL = 1e-4
N_STEPS = 4
GEN_SEED = 5     # a prompt whose greedy steps are all decided by a clear margin
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
        # qkv biases start at zero: give them values so that the bias path counts
        rng = np.random.default_rng(11)
        self.jparams["blocks"]["pos0"]["mixer"] = {
            k: (jnp.asarray(rng.standard_normal(v.shape, dtype=np.float32) * 0.1, v.dtype)
                if k.startswith("b") else v)
            for k, v in self.jparams["blocks"]["pos0"]["mixer"].items()}
        self.model = build_model(cfg)
        self.params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, self.jparams))
        self.engine = JaxServeEngine(self.jmodel)
        self.jprefill, self.jdecode = self.engine._prefill, self.engine._decode


@pytest.fixture(scope="module")
def fp32():
    return _Pair()


@pytest.fixture(scope="module")
def bf16():
    return _Pair(**BF16)


def _prompt(cfg, b=2, s=16, seed=1, dtype=torch.float32):
    """(JAX prompt, port prompt): seeded tokens (B, S), seeded normal vision
    embeddings (B, v, D) and pos_ids arange(v + S) on all three streams, as
    the launcher builds them."""
    rng = np.random.default_rng(seed)
    v = cfg.n_vision_tokens
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    emb = rng.standard_normal((b, v, cfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(v + s, dtype=np.int32), (3, b, v + s)).copy()
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jb = {"tokens": jnp.asarray(toks), "vision_embeds": jnp.asarray(emb, jdt),
          "pos_ids": jnp.asarray(pos)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "vision_embeds": torch.from_numpy(emb).to(dtype), "pos_ids": torch.from_numpy(pos).long()}
    return jb, tb


def _stacked(cache, jcache):
    for name, want in jcache["pos0"].items():
        yield name, torch.stack([layer[name] for layer in cache]).float().numpy(), want


def _jstep(tok, idx):
    b = tok.shape[0]
    return {"tokens": jnp.asarray(tok), "idx": jnp.array(idx, jnp.int32),
            "pos_ids": jnp.full((3, b, 1), idx, jnp.int32)}


def _step(tok, idx):
    """The port's decode batch as ServeEngine builds it for vlm."""
    return {"tokens": tok, "idx": idx,
            "pos_ids": torch.full((3, tok.shape[0], 1), idx, dtype=torch.int64)}


# ----------------------------------------------------------------- layers


@pytest.mark.parametrize("dh,theta,sections,s", [(64, 1e4, (16, 8, 8), 40),
                                                 (128, 1e6, (16, 24, 24), 2048)])
def test_mrope_angles_match_jax(dh, theta, sections, s):
    """(3, B, S) position ids -> cos/sin (B, S, dh/2) within one fp32 ulp of
    the JAX package's (its one-hot einsum and the port's gather pick the
    same angles); each section's slots follow its own stream."""
    pos = np.random.default_rng(0).integers(0, s, (3, 2, s)).astype(np.int32)
    jc, js = jlayers.mrope_angles(jnp.asarray(pos), dh, theta, sections)
    c, sn = L.mrope_angles(torch.from_numpy(pos).long(), dh, theta, sections)
    assert c.dtype == torch.float32 and tuple(c.shape) == (2, s, dh // 2)
    assert np.abs(c.numpy() - np.asarray(jc)).max() <= 1.2e-7
    assert np.abs(sn.numpy() - np.asarray(js)).max() <= 1.2e-7
    t, h, _ = sections
    for stream, lo, hi in ((0, 0, t), (1, t, t + h), (2, t + h, dh // 2)):
        one = torch.from_numpy(np.broadcast_to(pos[stream], (3, 2, s)).copy()).long()
        c1, _ = L.mrope_angles(one, dh, theta, sections)
        assert torch.equal(c1[..., lo:hi], c[..., lo:hi])
    with pytest.raises(ValueError, match="sections"):
        L.mrope_angles(torch.from_numpy(pos).long(), dh, theta, (1, 2, 3))


# ----------------------------------------------------------------- model


def test_forward_and_loss_match_jax(fp32):
    """Training logits over the vision prefix and the text; the loss drops
    the prefix (ce over the text labels only)."""
    cfg = fp32.model.cfg
    jb, tb = _prompt(cfg, s=12, seed=2)
    labels = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jb["labels"], tb["labels"] = jnp.asarray(labels), torch.from_numpy(labels).long()
    (jlogits, _), (jloss, jm) = jax.jit(
        lambda p, b: (fp32.jmodel.forward(p, b), fp32.jmodel.loss(p, b)))(fp32.jparams, jb)
    with torch.no_grad():
        logits, aux = fp32.model.forward(fp32.params, tb)
        loss, m = fp32.model.loss(fp32.params, tb)
    assert logits.shape[1] == cfg.n_vision_tokens + 12
    _close(logits, jlogits, TOL, "forward logits")
    for got, want in ((loss, jloss), (m["ce"], jm["ce"])):
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want)), (got, want)
    assert float(m["aux"]) == float(jm["aux"]) == 0.0


def test_prefill_and_decode_match_jax(fp32):
    """Prefill logits and K/V cache over vision + text, then N_STEPS decode
    steps (tokens, idx and pos_ids as the JAX engine passes them) fed the
    JAX greedy token: logits and the cache after each."""
    cfg = fp32.model.cfg
    jb, tb = _prompt(cfg, s=16, seed=4)
    jlogits, jcache = fp32.jprefill(fp32.jparams, jb)
    logits, cache = fp32.model.prefill(fp32.params, tb)
    _close(logits, jlogits, TOL, "prefill logits")
    for name, got, want in _stacked(cache, jcache):
        _close(got, want, TOL, f"prefill cache {name}")
    s0 = tb["tokens"].shape[1]
    jcache = jax_pad_cache(jcache, fp32.jmodel.cfg, s0 + N_STEPS)
    cache = _pad_cache(cache, s0 + N_STEPS)
    tok = np.asarray(jnp.argmax(jlogits, axis=-1))[:, None].astype(np.int32)
    for i in range(N_STEPS):
        jlogits, jcache = fp32.jdecode(fp32.jparams, _jstep(tok, s0 + i), jcache)
        logits, cache = fp32.model.decode_step(
            fp32.params, _step(torch.from_numpy(tok).long(), s0 + i), cache)
        _close(logits, jlogits, TOL, f"decode step {i} logits")
        for name, got, want in _stacked(cache, jcache):
            _close(got, want, TOL, f"decode step {i} cache {name}")
        tok = np.asarray(jnp.argmax(jlogits, axis=-1))[:, None].astype(np.int32)


class _Recorder:
    """The model, recording each decode step's batch, logits and top-2 logit
    margin relative to its largest |logit|."""

    def __init__(self, model):
        self.model, self.cfg = model, model.cfg
        self.margins, self.steps, self.logits = [], [], []

    def prefill(self, p, batch):
        out, cache = self.model.prefill(p, batch)
        self.prefill_cache = [{k: v.clone() for k, v in c.items()} for c in cache]
        return out, cache

    def decode_step(self, p, batch, cache):
        logits, cache = self.model.decode_step(p, batch, cache)
        top2 = torch.topk(logits, 2, dim=-1).values
        self.margins.append(float((top2[:, 0] - top2[:, 1]).min() / logits.abs().max()))
        self.steps.append(batch)
        self.logits.append(logits)
        return logits, cache


def test_generate_matches_jax_engine(fp32):
    jb, tb = _prompt(fp32.model.cfg, s=16, seed=GEN_SEED)
    jout, _ = fp32.engine.generate(fp32.jparams, jb, max_new_tokens=N_STEPS)
    recorder = _Recorder(fp32.model)
    out, cache = ServeEngine(recorder).generate(fp32.params, tb, N_STEPS)
    assert out.shape == (2, N_STEPS) and len(cache) == fp32.model.cfg.n_layers
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert min(recorder.margins[:-1]) > 10 * TOL, recorder.margins


def test_decode_overwrites_the_prompt_as_the_reference_does(fp32):
    """ROADMAP C9, a fault of the reference kept for parity.  The JAX engine
    decodes at idx = s0 + i and M-RoPE position s0 + i, s0 the prompt's
    TEXT tokens, while the prefill cache holds the v vision slots before the
    text.  So decode step i overwrites the K/V of the prompt's text slot
    s0 + i and attends only to positions <= s0 + i: the decode sees the
    vision prefix and the first text tokens, not the end of the prompt.
    The port's engine does exactly this (its logits and cache equal the JAX
    engine's), and a decode at the true next position (v + s0) gives other
    logits."""
    cfg = fp32.model.cfg
    v, s0 = cfg.n_vision_tokens, 16
    jb, tb = _prompt(cfg, s=s0, seed=6)
    jout, jcache = fp32.engine.generate(fp32.jparams, jb, max_new_tokens=N_STEPS)
    recorder = _Recorder(fp32.model)
    out, cache = ServeEngine(recorder).generate(fp32.params, tb, N_STEPS)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert [int(st["idx"]) for st in recorder.steps] == list(range(s0, s0 + N_STEPS))
    assert all(torch.equal(st["pos_ids"], torch.full((3, 2, 1), s0 + i, dtype=torch.int64))
               for i, st in enumerate(recorder.steps))
    for name, got, want in _stacked(cache, jcache):
        _close(got, want, TOL, f"final cache {name}")
    # the cache was not padded (v + s0 >= s0 + N_STEPS); steps wrote over
    # slots s0 .. s0 + N_STEPS - 1, which held the prompt's text tokens
    # 0 .. N_STEPS - 1, and left every other slot as prefill wrote it
    assert cache[0]["k"].shape[1] == v + s0 and s0 >= v
    for before, after in zip(recorder.prefill_cache, cache):
        hit = slice(s0, s0 + N_STEPS)
        assert not torch.equal(after["k"][:, hit], before["k"][:, hit])
        for keep in (slice(0, s0), slice(s0 + N_STEPS, v + s0)):
            assert torch.equal(after["k"][:, keep], before["k"][:, keep])
    # the first step at the true next position gives other logits
    logits, fresh = fp32.model.prefill(fp32.params, tb)
    fresh = _pad_cache(fresh, v + s0 + 1)
    tok = out[:, :1]
    moved, _ = fp32.model.decode_step(fp32.params, _step(tok, v + s0), fresh)
    assert _normwise(moved, recorder.logits[0]) > 100 * TOL


def _jax_forced(pair, params, batch, forced):
    logits, cache = pair.jprefill(params, batch)
    s0 = batch["tokens"].shape[1]
    cache = jax_pad_cache(cache, pair.jmodel.cfg, s0 + forced.shape[1])
    out = [logits]
    for j in range(forced.shape[1]):
        logits, cache = pair.jdecode(params, _jstep(forced[:, j:j + 1], s0 + j), cache)
        out.append(logits)
    return [np.asarray(jnp.asarray(x, jnp.float32), np.float64) for x in out]


def _torch_forced(model, params, batch, forced):
    logits, cache = model.prefill(params, batch)
    s0 = batch["tokens"].shape[1]
    cache = _pad_cache(cache, s0 + forced.shape[1])
    out = [logits]
    for j in range(forced.shape[1]):
        logits, cache = model.decode_step(
            params, _step(torch.from_numpy(forced[:, j:j + 1]).long(), s0 + j), cache)
        out.append(logits)
    return [x.float().numpy().astype(np.float64) for x in out]


def test_bf16_serving_within_the_reference_gap(fp32, bf16):
    """bf16 smoke config from the same bf16 parameters: prefill and 4
    decode steps fed the JAX bf16 engine's greedy tokens.  At each step the
    port's bf16 logits lie within 2x the reference's own bf16-vs-fp32 gap
    (its bf16 logits against its fp32 logits from the upcast parameters) of
    the JAX bf16 logits, and the argmax agrees wherever the JAX bf16 top-2
    margin exceeds twice that bound."""
    jb16, tb16 = _prompt(bf16.model.cfg, s=16, seed=7, dtype=torch.bfloat16)
    jb32, _ = _prompt(bf16.model.cfg, s=16, seed=7)
    forced, _ = bf16.engine.generate(bf16.jparams, jb16, max_new_tokens=N_STEPS)
    forced = np.asarray(forced).astype(np.int32)
    jparams32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), bf16.jparams)
    ref16 = _jax_forced(bf16, bf16.jparams, jb16, forced)
    ref32 = _jax_forced(fp32, jparams32, jb32, forced)
    got = _torch_forced(bf16.model, bf16.params, tb16, forced)
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


# ------------------------------------------------- data, train, convert


@pytest.mark.parametrize("over", [{}, BF16])
def test_lm_batches_match_jax(over):
    """tokens, labels, vision_embeds (the float32 normals cast to the
    compute dtype) and pos_ids equal the JAX package's, bit for bit; the
    text is seq less the vision tokens."""
    jmodel = jax_build_model(dataclasses.replace(jax_get_config(ARCH, smoke=True), **over))
    model = build_model(dataclasses.replace(get_config(ARCH, smoke=True), **over))
    jit = jax_lm_batches(jmodel, seq=40, batch=3, seed=2, data_vocab=64)
    it = lm_batches(model, seq=40, batch=3, seed=2, data_vocab=64, device="cpu")
    for _ in range(2):
        jb, b = next(jit), next(it)
        assert sorted(b) == sorted(jb) == ["labels", "pos_ids", "tokens", "vision_embeds"]
        assert b["vision_embeds"].dtype == model.cfg.cdtype()
        np.testing.assert_array_equal(b["vision_embeds"].float().numpy(),
                                      np.asarray(jb["vision_embeds"], np.float32))
        assert b["tokens"].shape == b["labels"].shape == (3, 24)
        assert b["pos_ids"].shape == (3, 3, 40)
        for key in ("tokens", "labels", "pos_ids"):
            assert b[key].dtype == torch.int64
            np.testing.assert_array_equal(b[key].numpy(), np.asarray(jb[key]))


def test_microbatches_split_pos_ids_at_the_batch_dim():
    """pos_ids (3, B, S) split at dim 1: at the configs' microbatch counts
    (1 and 2) equal to the JAX package's split of every leaf; at n = 3 the
    JAX split (which picks dim 0 wherever n divides it) cuts the three
    position streams apart, and the port's keeps them."""
    model = build_model(get_config(ARCH, smoke=True))
    batch = next(lm_batches(model, seq=28, batch=6, device="cpu"))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    for n in (1, 2):
        got, want = _microbatches(batch, n), jax_microbatches(jbatch, n)
        assert got["pos_ids"].shape == (n, 3, 6 // n, 28)
        for key in batch:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    got, want = _microbatches(batch, 3), jax_microbatches(jbatch, 3)
    assert got["pos_ids"].shape == (3, 3, 2, 28) and want["pos_ids"].shape == (3, 1, 6, 28)
    assert torch.equal(got["pos_ids"][1], batch["pos_ids"][:, 2:4])
    with pytest.raises(ValueError, match="pos_ids"):
        _microbatches({"pos_ids": batch["pos_ids"]}, 4)


def test_convert_round_trips_bit_for_bit():
    """A bf16 JAX tree crosses to the port's layers with vision_proj and
    back to the stacked layout bit for bit."""
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), **BF16)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), **BF16)
    tree = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    params = lm_params_from_numpy(cfg, tree)
    assert params["vision_proj"].dtype == torch.bfloat16
    np.testing.assert_array_equal(params["vision_proj"].view(torch.int16).numpy(),
                                  tree["vision_proj"].view(np.int16))
    back = lm_params_to_tree(cfg, params)
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(flat)
    for path, want in flat:
        np.testing.assert_array_equal(got[path].view(torch.int16).numpy(), want.view(np.int16))


def test_launchers_run_on_cpu(capsys):
    assert launch_serve.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "12",
                              "--new-tokens", "4", "--device", "cpu"]) == 0
    assert "generated (2, 4)" in capsys.readouterr().out
    prompt = launch_serve.build_prompt(get_config(ARCH, smoke=True), 2, 12)
    assert sorted(prompt) == ["pos_ids", "tokens", "vision_embeds"]
    assert prompt["vision_embeds"].shape == (2, 16, 256) and not prompt["vision_embeds"].any()
    assert torch.equal(prompt["pos_ids"][2, 1], torch.arange(28, dtype=torch.int64))
    assert launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                              "--seq", "32", "--batch", "2"]) == 0
    assert "step    1 loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch,key", [("qwen2-vl-7b", "vision_embeds"),
                                      ("whisper-medium", "frames")])
def test_build_prompt_seeds_the_stub_inputs(arch, key):
    """With `seed`, build_prompt's frames or vision embeddings are the CPU
    generator's float32 normals cast to the compute dtype, the same on every
    call; everything else is the unseeded (JAX launcher's) prompt."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), **BF16)
    plain = launch_serve.build_prompt(cfg, 2, 12)
    seeded = launch_serve.build_prompt(cfg, 2, 12, seed=3)
    assert sorted(seeded) == sorted(plain)
    for name in plain:
        if name != key:
            assert torch.equal(seeded[name], plain[name]), name
    want = torch.randn(plain[key].shape, generator=torch.Generator().manual_seed(3),
                       dtype=torch.float32).to(torch.bfloat16)
    assert seeded[key].dtype == torch.bfloat16 and torch.equal(seeded[key], want)
    assert torch.equal(launch_serve.build_prompt(cfg, 2, 12, seed=3)[key], want)
    assert not torch.equal(launch_serve.build_prompt(cfg, 2, 12, seed=4)[key], want)
