"""The port's training step, data and launcher (repro_torch.train,
repro_torch.data.lm.lm_batches, repro_torch.launch.train) against the JAX
package's, on the CPU, at the smollm-360m and rwkv6-1.6b smoke configs.

Both packages start from the JAX package's TrainState (its init_state,
carried across by convert.train_state_from_numpy) and take the same batches
(lm_batches gives the JAX package's tokens, as int64): one step's loss,
grad norm and learning rate within 1e-5 relative, with microbatch 1 and 2
(the gradients summed in fp32 over the microbatches), and three steps'
losses within 1e-4 (AdamW's first steps move each parameter by about
lr * sign(g), so later steps amplify ulp-level gradient differences; the
gradients themselves are held in test_torch_lm_grad.py).  The port's remat
(torch.utils.checkpoint over each group of scan_block layers) gives the
same bits as no remat.  A params checkpoint written by either package
restores in the other.  The entry points run on the card unless asked.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import INPUT_SHAPES as JAX_INPUT_SHAPES
from repro.configs import RunConfig as JaxRunConfig
from repro.configs import get_config as jax_get_config
from repro.data.lm import lm_batches as jax_lm_batches
from repro.models import build_model as jax_build_model
from repro.models.model import shape_check as jax_shape_check
from repro.train import init_state as jax_init_state
from repro.train import make_train_step as jax_make_train_step
from repro.train import train_state_specs as jax_train_state_specs
from repro_torch.checkpoint.io import restore_checkpoint, save_checkpoint
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, RunConfig, get_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_tree, train_state_from_numpy
from repro_torch.data.lm import lm_batches
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, shape_check
from repro_torch.optim.clip import tree_leaves
from repro_torch.train import init_state, make_train_step, train_state_specs

ARCHS = ["smollm-360m", "rwkv6-1.6b"]
RUN = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """One intra-op thread for this module: its tensors are small, and
    beside other pytest workers torch's default pool (a thread a core in
    each worker) only contends for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _pair(arch, **overrides):
    """(JAX model, its TrainState, port model, the same TrainState)."""
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), **overrides)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **overrides)
    jmodel = jax_build_model(jcfg)
    jstate = jax_init_state(jmodel, jax.random.PRNGKey(0), JaxRunConfig(**RUN))
    state = train_state_from_numpy(cfg, jax.tree.map(np.asarray, jstate.params),
                                   jax.tree.map(np.asarray, jstate.opt), np.asarray(jstate.step))
    return jmodel, jstate, build_model(cfg), state


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_from_numpy_carries_the_jax_state(arch):
    jmodel, jstate, model, state = _pair(arch)
    assert state.step.dtype == torch.int32 and int(state.step) == 0
    assert state.opt["count"].dtype == torch.int32 and int(state.opt["count"]) == 0
    want = lm_params_from_numpy(model.cfg, jax.tree.map(np.asarray, jstate.params))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state.params), tree_leaves(want)))
    back = lm_params_to_tree(model.cfg, state.params)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jstate.params)),
                    tree_leaves(back)):
        assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("microbatch", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, microbatch):
    """One step's loss, grad norm and lr within 1e-5 relative; then two more
    steps' losses within 1e-4.  The new state's dtypes are the JAX state's."""
    jmodel, jstate, model, state = _pair(arch, microbatch=microbatch)
    jstep = jax.jit(jax_make_train_step(jmodel, JaxRunConfig(**RUN)))
    step = make_train_step(model, RunConfig(**RUN))
    jbatches = jax_lm_batches(jmodel, seq=32, batch=4)
    batches = lm_batches(model, seq=32, batch=4, device="cpu")
    for i in range(3):
        jstate, jmet = jstep(jstate, next(jbatches))
        state, met = step(state, next(batches))
        tol = 1e-5 if i == 0 else 1e-4
        for key in (("loss", "grad_norm", "lr") if i == 0 else ("loss",)):
            assert _rel(met[key], jmet[key]) <= tol, (i, key, float(met[key]),
                                                      float(jmet[key]))
    assert int(state.step) == int(jstate.step) == 3 and int(state.opt["count"]) == 3
    for a, b in zip(tree_leaves(state.opt["mu"]), jax.tree.leaves(jstate.opt["mu"])):
        assert str(a.dtype).removeprefix("torch.") == b.dtype.name


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_bits(arch):
    """Two layers in one checkpointed group (scan_block 2) and in two
    (scan_block 1), against no remat: one step's loss, grad norm and new
    parameters bit for bit."""
    runs = []
    for remat, block in ((False, 1), (True, 1), (True, 2)):
        _, _, model, state = _pair(arch, remat=remat, scan_block=block)
        new, met = make_train_step(model, RunConfig(**RUN))(
            state, next(lm_batches(model, seq=32, batch=2, device="cpu")))
        runs.append((met, list(tree_leaves(new.params))))
    (m0, p0), *others = runs
    for met, params in others:
        assert all(torch.equal(met[k], m0[k]) for k in ("loss", "grad_norm", "lr"))
        assert all(torch.equal(a, b) for a, b in zip(params, p0))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_batches_match_jax(arch):
    jmodel = jax_build_model(jax_get_config(arch, smoke=True))
    model = build_model(get_config(arch, smoke=True))
    for kw in ({}, {"seed": 3, "data_vocab": 64}):
        jit, it = jax_lm_batches(jmodel, seq=20, batch=3, **kw), lm_batches(
            model, seq=20, batch=3, device="cpu", **kw)
        for _ in range(3):
            jb, b = next(jit), next(it)
            assert sorted(b) == sorted(jb) == ["labels", "tokens"]
            for key in b:
                assert b[key].dtype == torch.int64 and b[key].shape == (3, 20)
                assert np.array_equal(b[key].numpy(), np.asarray(jb[key]))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_shape_check_match_jax(arch):
    for name, shape in INPUT_SHAPES.items():
        assert shape_check(get_config(arch), shape) == jax_shape_check(
            jax_get_config(arch), JAX_INPUT_SHAPES[name])
    model, jmodel = build_model(get_config(arch)), jax_build_model(jax_get_config(arch))
    for name, shape in INPUT_SHAPES.items():
        specs, jspecs = model.input_specs(shape), jmodel.input_specs(JAX_INPUT_SHAPES[name])
        assert sorted(specs) == sorted(jspecs)
        for key, spec in specs.items():
            assert spec.shape == jspecs[key].shape
            if jnp.issubdtype(jspecs[key].dtype, jnp.integer):
                assert spec.dtype == torch.int64, key
            else:   # frames, vision_embeds: the compute dtype
                assert str(spec.dtype).removeprefix("torch.") == jspecs[key].dtype.name, key


def _spec_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _spec_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _spec_leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_specs_match_jax(arch):
    cfg = get_config(arch, smoke=True)
    specs = train_state_specs(build_model(cfg), RunConfig())
    jspecs = jax_train_state_specs(jax_build_model(jax_get_config(arch, smoke=True)),
                                   JaxRunConfig())
    for part in ("params", "mu", "nu"):
        got = specs.params if part == "params" else specs.opt[part]
        want = jspecs.params if part == "params" else jspecs.opt[part]
        # the port keeps one dict a layer: each JAX leaf is n_layers of them
        gl = list(_spec_leaves(got))
        assert sum(int(np.prod(s.shape)) for s in gl) == sum(
            int(np.prod(s.shape)) for s in jax.tree.leaves(want))
        assert {str(s.dtype).removeprefix("torch.") for s in gl} == {
            s.dtype.name for s in jax.tree.leaves(want)}
    assert specs.step.shape == () and specs.step.dtype == torch.int32


@pytest.mark.parametrize("arch", ARCHS)
def test_params_checkpoint_crosses_packages(arch, tmp_path):
    jmodel, jstate, model, state = _pair(arch)
    jax_save(str(tmp_path / "jax"), 7, jstate.params)
    restored = lm_params_from_numpy(model.cfg, restore_checkpoint(
        str(tmp_path / "jax"), 7, lm_params_to_tree(model.cfg, state.params)))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(restored),
                                                 tree_leaves(state.params)))
    save_checkpoint(str(tmp_path / "port"), 7, lm_params_to_tree(model.cfg, state.params))
    back = jax_restore(str(tmp_path / "port"), 7, jstate.params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate.params)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b))


def test_launch_train_runs_on_the_cpu_and_resumes(tmp_path, capsys):
    args = ["--arch", "smollm-360m", "--smoke", "--device", "cpu", "--steps", "3",
            "--seq", "32", "--batch", "2", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    assert launch_train.main(args) == 0
    out = capsys.readouterr().out
    assert "step    0 loss" in out and "step    2 loss" in out
    assert (tmp_path / "ckpt_00000002.npz").is_file()
    assert launch_train.main(args) == 0
    assert "restored step 2 from" in capsys.readouterr().out
    assert launch_train.main(["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu", "--steps",
                              "3", "--seq", "16", "--batch", "2"]) == 0


def test_training_entry_points_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(get_config("smollm-360m", smoke=True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(model, 0, RunConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "smollm-360m", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(lm_batches(model, seq=8, batch=1))
    state = init_state(model, 0, RunConfig(), device="cpu")
    assert state.step.device.type == "cpu" and int(state.step) == 0
