"""repro_torch.checkpoint.io against repro.checkpoint.io: one file layout.

A tree of dicts, lists and tuples saved by either package restores in the
other with the same arrays (bfloat16 stored as float32 and cast back),
`tree_keys` gives the JAX package's keys in its leaf order, the manifest
matches field for field (the tree structure as jax.tree_util prints it),
and `stored_keys` / `latest_step` read either package's directories.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro_torch.checkpoint import io as tio


def _trees():
    rng = np.random.default_rng(0)
    arrays = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in (("a", (3, 4)), ("b", (5,)), ("c", (2, 2)),
                           ("d", ()), ("e", (7,)))}
    jtree = {"params": jnp.asarray(arrays["a"]),
             "opt": [jnp.asarray(arrays["b"]),
                     (jnp.asarray(arrays["c"]), jnp.asarray(arrays["d"]))],
             "emb": jnp.asarray(arrays["e"]).astype(jnp.bfloat16)}
    ttree = {"params": torch.from_numpy(arrays["a"]),
             "opt": [torch.from_numpy(arrays["b"]),
                     (torch.from_numpy(arrays["c"]), torch.from_numpy(arrays["d"]))],
             "emb": torch.from_numpy(arrays["e"]).to(torch.bfloat16)}
    return jtree, ttree


def _flat(tree):
    return [np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor)
            else x.float().numpy() for x in _leaves(tree)]


def _leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for x in tree for v in _leaves(x)]
    return [tree]


def test_tree_keys_match_jax():
    jtree, ttree = _trees()
    assert tio.tree_keys(ttree) == jio.tree_keys(jtree) == [
        "emb", "opt|0", "opt|1|0", "opt|1|1", "params"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_written_by_one_restores_in_the_other(tmp_path, writer):
    jtree, ttree = _trees()
    if writer == "port":
        tio.save_checkpoint(str(tmp_path), 7, ttree)
    else:
        jio.save_checkpoint(str(tmp_path), 7, jtree)
    j_back = jio.restore_checkpoint(str(tmp_path), 7, jtree)
    t_back = tio.restore_checkpoint(str(tmp_path), 7, ttree)
    assert t_back["emb"].dtype == torch.bfloat16 and isinstance(t_back["opt"][1], tuple)
    for a, b, want in zip(_flat(t_back), _flat(j_back), _flat(ttree)):
        np.testing.assert_array_equal(a, want)
        np.testing.assert_array_equal(b, want)
    with open(tmp_path / "ckpt_00000007.json") as fh:
        manifest = json.load(fh)
    assert manifest == {"step": 7, "keys": sorted(jio.tree_keys(jtree)),
                        "treedef": str(jax.tree_util.tree_structure(jtree))}
    assert tio.stored_keys(str(tmp_path), 7) == jio.stored_keys(str(tmp_path), 7)


def test_latest_step(tmp_path):
    assert tio.latest_step(str(tmp_path / "missing")) is None
    assert tio.latest_step(str(tmp_path)) is None
    _, ttree = _trees()
    for step in (3, 12, 5):
        tio.save_checkpoint(str(tmp_path), step, ttree)
    assert tio.latest_step(str(tmp_path)) == jio.latest_step(str(tmp_path)) == 12


# ----------------------------------------------------- NamedTuple trees


def _named_trees():
    """A NamedTuple holding a nested NamedTuple, a tuple and a dict, in
    each package (jax keys a NamedTuple's fields '.name')."""
    from typing import NamedTuple

    class Inner(NamedTuple):
        u: object
        v: object

    class S(NamedTuple):
        a: object
        b: object
        c: object

    rng = np.random.default_rng(1)
    a = rng.standard_normal(3)
    u, v, x = rng.standard_normal((2, 2)), rng.standard_normal(1), rng.standard_normal(4)
    jt = S(a=jnp.asarray(a, jnp.float32),
           b=(jnp.zeros(1, jnp.float32), {"x": jnp.asarray(x, jnp.float32)}),
           c=Inner(u=jnp.asarray(u, jnp.float32), v=jnp.asarray(v, jnp.float32)))
    tt = S(a=torch.tensor(a, dtype=torch.float32),
           b=(torch.zeros(1), {"x": torch.tensor(x, dtype=torch.float32)}),
           c=Inner(u=torch.tensor(u, dtype=torch.float32),
                   v=torch.tensor(v, dtype=torch.float32)))
    return jt, tt


def test_named_tuple_keys_and_treedef_match_jax():
    jt, tt = _named_trees()
    assert tio.tree_keys(tt) == jio.tree_keys(jt) == [
        ".a", ".b|0", ".b|1|x", ".c|.u", ".c|.v"]
    assert (f"PyTreeDef({tio._treedef(tt)})"
            == str(jax.tree_util.tree_structure(jt)))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_named_tuple_checkpoint_restores_in_the_other(tmp_path, writer):
    jt, tt = _named_trees()
    if writer == "port":
        tio.save_checkpoint(str(tmp_path), 3, tt)
    else:
        jio.save_checkpoint(str(tmp_path), 3, jt)
    t_back = tio.restore_checkpoint(str(tmp_path), 3, tt)
    j_back = jio.restore_checkpoint(str(tmp_path), 3, jt)
    assert type(t_back) is type(tt) and type(t_back.c) is type(tt.c)
    for a, b, want in zip(_flat(t_back), _flat(j_back), _flat(tt)):
        np.testing.assert_array_equal(a, want)
        np.testing.assert_array_equal(b, want)
    with open(tmp_path / "ckpt_00000003.json") as fh:
        manifest = json.load(fh)
    assert manifest["treedef"] == str(jax.tree_util.tree_structure(jt))
    assert manifest["keys"] == sorted(jio.tree_keys(jt))


@pytest.mark.parametrize("x64", [False, True])
def test_stream_state_checkpoint_crosses_packages(tmp_path, x64):
    """A StreamState saved by either package restores in the other, every
    leaf cast to the template's dtype: the JAX key's uint32 words into the
    port's int64 key, the JAX ledger's default int into the port's Python
    int, the int32 scalars into the port's numpy int32 (and back)."""
    from repro import api as japi
    from repro.stream.run import build_ingestor as jbuild
    from repro_torch import api as tapi
    from repro_torch.stream import build_ingestor as tbuild

    d = {"experiment": {"data": {"source": "cosine"}}, "window": 64,
         "chunk": 32, "resweep_every": 64, "total_instances": 64}
    dt = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64 if x64 else torch.float32)
    try:
        with jax.enable_x64(x64):
            jing = jbuild(japi.stream_spec_from_dict(d))
            tstate = tbuild(tapi.stream_spec_from_dict(d), device="cpu").init_state()
            jstate = jing.init_state()
            jstate = jstate._replace(count=jnp.asarray(96, jnp.int32),
                                     ledger=jstate.ledger.charge(12345))
            tstate = tstate._replace(count=np.int32(96), cursor=np.int32(32),
                                     ledger=tstate.ledger.charge(777))
            assert tio.tree_keys(tstate) == jio.tree_keys(jstate)
            assert (f"PyTreeDef({tio._treedef(tstate)})"
                    == str(jax.tree_util.tree_structure(jstate)))
            jio.save_checkpoint(str(tmp_path / "j"), 96, jstate)
            tio.save_checkpoint(str(tmp_path / "t"), 96, tstate)
            t_from_j = tio.restore_checkpoint(str(tmp_path / "j"), 96, tstate)
            j_from_t = jio.restore_checkpoint(str(tmp_path / "t"), 96, jstate)
    finally:
        torch.set_default_dtype(dt)
    assert t_from_j.ledger.spent == 12345 and t_from_j.count == 96
    assert isinstance(t_from_j.count, np.int32)
    assert t_from_j.key.dtype == torch.int64
    assert t_from_j.key.tolist() == np.asarray(jstate.key).tolist()
    assert t_from_j.y.dtype == tstate.y.dtype
    assert int(j_from_t.ledger.spent) == 777 and int(j_from_t.cursor) == 32
    assert j_from_t.ledger.spent.dtype == jstate.ledger.spent.dtype
    assert j_from_t.key.dtype == jnp.uint32
    assert np.asarray(j_from_t.key).tolist() == tstate.key.tolist()
    np.testing.assert_array_equal(np.asarray(j_from_t.cov.m_inv),
                                  tstate.cov.m_inv.numpy())
