"""The threefry2x32 key stream of jax.random, bit for bit, in PyTorch.

The JAX package draws Minimax Protection's subsample from
`jax.random.permutation` of keys split out of `PRNGKey(seed + 1)`.  This
module reproduces the default generator of jax 0.9.0 (`threefry2x32` with
`jax_threefry_partitionable=True`) so that the port, given the same seed,
transmits the same instances:

    PRNGKey(seed)          (2,) key: the high and low 32-bit words of seed
    split(key, num)        (num, 2) keys: threefry of (0, k) for k < num
    bits(key, shape)       uint32 words: the xor of threefry's two outputs
                           on the 64-bit counters 0 .. prod(shape) - 1
    permutation(key, n)    jax's sort-based shuffle of arange(n): per round
                           split the key, draw 32-bit sort keys, stable sort

A key is an int64 tensor whose last axis holds the two uint32 words, so a
(B, 2) tensor is one key per Monte-Carlo trial and every function maps over
the leading axes.  Words are carried in int64 and masked to 32 bits after
each addition: torch's uint32 lacks shifts and rotations on some CUDA
builds.  Everything runs on the device of the key, with no host round trip.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

__all__ = ["PRNGKey", "split", "bits", "permutation", "threefry2x32",
           "shuffle_rounds"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: Union[int, Sequence[int], torch.Tensor],
            device="cpu") -> torch.Tensor:
    """The raw key of an integer seed, (2,); a sequence (or int tensor) of B
    seeds gives B keys, (B, 2)."""
    s = torch.as_tensor(seed, dtype=torch.int64).to(device)
    return torch.stack([(s >> 32) & _MASK, s & _MASK], dim=-1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter words (x0, x1)
    under the key words (k0, k1); all int64 holding uint32 values, any
    broadcastable shapes.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & _MASK
        x1 = (x1 + ks[(block + 2) % 3] + (block + 1)) & _MASK
    return x0, x1


def _counters(shape, device):
    """The two 32-bit words of the 64-bit iota over `shape` (jax's
    iota_2x32_shape)."""
    n = math.prod(shape)
    iota = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return iota >> 32, iota & _MASK


def _hash(key: torch.Tensor, shape):
    """threefry of the counters over `shape` under each key of `key`
    (..., 2): two words of shape (..., *shape)."""
    lead = key.shape[:-1]
    pad = (1,) * len(shape)
    k0 = key[..., 0].reshape(*lead, *pad)
    k1 = key[..., 1].reshape(*lead, *pad)
    hi, lo = _counters(shape, key.device)
    return threefry2x32(k0, k1, hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`num` new keys from each key: (..., 2) -> (..., num, 2)."""
    w0, w1 = _hash(key, (num,))
    return torch.stack([w0, w1], dim=-1)


def bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """Uniform 32-bit words (int64 tensor of uint32 values) of `shape`
    under each key: (..., 2) -> (..., *shape)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    w0, w1 = _hash(key, shape)
    return w0 ^ w1


def shuffle_rounds(n: int) -> int:
    """Sort rounds of jax's shuffle for n elements: ceil(3 ln n / ln(2^32 - 1)),
    evaluated as jax evaluates it (numpy float64)."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """A random permutation of arange(n) (int64) per key: (..., 2) ->
    (..., n), jax.random.permutation(key, n)'s values."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    x = x.expand(*key.shape[:-1], n)
    for _ in range(shuffle_rounds(n)):
        keys = split(key)
        key, sub = keys[..., 0, :], keys[..., 1, :]
        order = torch.sort(bits(sub, (n,)), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x
