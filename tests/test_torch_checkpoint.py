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
