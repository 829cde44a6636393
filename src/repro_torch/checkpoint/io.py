"""Host-gather numpy checkpointing (twin of repro.checkpoint.io).

A tree of dicts, lists, tuples and NamedTuples of tensors is flattened
with its paths into one .npz per step plus a small JSON manifest, in the
JAX package's layout, so either package reads the other's files (the port
stores the arrays uncompressed, as np.savez: zlib takes minutes for an
LM's parameters and saves little on float data; np.load reads both):

    ckpt_%08d.npz    one array per leaf, keyed by its path: dict keys in
                     sorted order, list / tuple positions and NamedTuple
                     fields as jax names them (".field"), joined by "|"
    ckpt_%08d.json   {"step", "keys" (sorted), "treedef"}: the tree's
                     structure written as jax.tree_util writes it

A dataclass is walked as a NamedTuple: the port's twins of the JAX
package's NamedTuples (the transport Ledger) are dataclasses, so a stream
state's ledger gets the JAX package's key (".ledger|.spent") and node.

bfloat16 leaves are stored as float32 (numpy has no bfloat16) and cast back
on restore.  A Python int or float leaf (a byte ledger's `spent`, say) is
stored as a 0-d array, int64 for an int, as jax stores a scalar under
jax_enable_x64, and a numpy scalar (a stream's int32 ring cursor) as a 0-d
array of its own dtype; each is restored as the like's type.  Restore casts
every leaf to the like's dtype, whichever package wrote it (a JAX key's
uint32 words into the port's int64 key, say).  No pytree library: the tree
walk is written out below.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, List, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "tree_keys", "stored_keys"]

_SEP = "|"


def _fields(tree: Any):
    """The (name, value) fields of a NamedTuple or a dataclass instance —
    the nodes jax keys by attribute — else None."""
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return list(zip(tree._fields, tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    return None


def _leaves(tree: Any, path=()):
    """(path, leaf) for every leaf, in jax's order (dict keys sorted)."""
    fields = _fields(tree)
    if fields is not None:
        for name, v in fields:
            yield from _leaves(v, path + ("." + name,))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


def _treedef(tree: Any) -> str:
    fields = _fields(tree)
    if fields is not None:
        inner = ", ".join(_treedef(v) for _, v in fields)
        return f"CustomNode(namedtuple[{type(tree).__name__}], [{inner}])"
    if isinstance(tree, dict):
        inner = ", ".join(f"{k!r}: {_treedef(tree[k])}" for k in sorted(tree))
        return "{" + inner + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_treedef(v) for v in tree)
        return "(" + inner + ("," if len(tree) == 1 else "") + ")"
    return "*"


def tree_keys(tree: Any) -> List[str]:
    """The flat npz key of every leaf of `tree`, in leaf order."""
    return [_SEP.join(p) for p, _ in _leaves(tree)]


def stored_keys(directory: str, step: int) -> List[str]:
    """Keys actually present in the step's npz archive."""
    with np.load(os.path.join(directory, f"ckpt_{step:08d}.npz")) as data:
        return sorted(data.files)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, dtype=np.int64)
    return np.asarray(leaf)         # a numpy scalar keeps its dtype


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    os.makedirs(directory, exist_ok=True)
    flat = {_SEP.join(p): _to_numpy(leaf) for p, leaf in _leaves(tree)}
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    np.savez(path, **flat)
    manifest = {"step": step, "keys": sorted(flat),
                "treedef": f"PyTreeDef({_treedef(tree)})"}
    with open(os.path.join(directory, f"ckpt_{step:08d}.json"), "w") as fh:
        json.dump(manifest, fh)
    return path


def _rebuild(like: Any, leaves) -> Any:
    fields = _fields(like)
    if fields is not None:
        values = {name: _rebuild(v, leaves) for name, v in fields}
        if isinstance(like, tuple):
            return type(like)(**values)
        return dataclasses.replace(like, **values)
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def _as_like(arr: np.ndarray, leaf) -> Any:
    """A stored array as the like's leaf: a tensor of its dtype on its
    device, or its Python / numpy scalar type."""
    if not isinstance(leaf, torch.Tensor):
        return type(leaf)(arr.item())
    np_dt = (np.float32 if leaf.dtype == torch.bfloat16     # stored as float32
             else torch.empty((), dtype=leaf.dtype, device="cpu").numpy().dtype)
    t = torch.from_numpy(np.array(arr, dtype=np_dt, order="C"))
    return t.to(device=leaf.device, dtype=leaf.dtype)


def restore_checkpoint(directory: str, step: int, like: Any) -> Any:
    """Restore into the structure of `like`: each leaf cast to the dtype of
    its tensor in `like`, on that tensor's device (a Python int or float
    leaf, or a numpy scalar, of `like` comes back as that type)."""
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        out = [_as_like(np.array(data[_SEP.join(p)]), leaf)
               for p, leaf in _leaves(like)]
    return _rebuild(like, iter(out))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None
