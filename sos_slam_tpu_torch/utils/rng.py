"""Threefry-2x32 random numbers, bit for bit those of `jax.random`.

The JAX package draws the selector's block directions and keep-masks, the
initializer's keep-mask and the per-keyframe keys from `jax.random`
(PRNGKey / split / fold_in / uniform). The port reproduces those draws
exactly so that both packages pick the same pixels from the same images:
this is a numpy implementation of the threefry2x32 hash and of JAX's key
derivations under `jax_threefry_partitionable` (the default since jax
0.5): split and uniform hash a 64-bit iota split into (hi, lo) words.

Keys are numpy uint32 arrays of shape (2,). Draws are small (at most one
value per pixel of one image per keyframe) and are made on the host.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash of the count words (x0, x1) under key
    (k1, k2): 20 rounds with a key injection after every 4."""
    k1 = np.uint32(k1)
    k2 = np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:
    """jax.random.PRNGKey: the 64-bit seed as two uint32 words."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s >> 32, s & 0xFFFFFFFF], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """jax.random.fold_in: hash of the count pair (0, data)."""
    d = np.array([int(data) & 0xFFFFFFFF], np.uint32)
    o0, o1 = threefry2x32(key[0], key[1], np.zeros(1, np.uint32), d)
    return np.array([o0[0], o1[0]], np.uint32)


def _iota_2x32(n: int):
    lo = np.arange(n, dtype=np.uint64)
    return ((lo >> np.uint64(32)).astype(np.uint32),
            (lo & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """jax.random.split: (num, 2) keys from the hashed 64-bit iota."""
    hi, lo = _iota_2x32(num)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return np.stack([b1, b2], -1)


def uniform(key: np.ndarray, shape: Union[int, Sequence[int]] = ()) -> np.ndarray:
    """jax.random.uniform(key, shape) in float32 on [0, 1): 23 random
    mantissa bits under exponent 0, minus one."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = int(math.prod(shape))
    hi, lo = _iota_2x32(n)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    bits = (b1 ^ b2) >> np.uint32(9)
    bits = bits | np.uint32(0x3F800000)
    f = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(np.float32(0.0), f).reshape(shape)


def normal(key: np.ndarray,
           shape: Union[int, Sequence[int]] = ()) -> np.ndarray:
    """jax.random.normal(key, shape) in float32: sqrt(2) erfinv(u) of a
    uniform u on (-1, 1) drawn from the same bits as `uniform`. The draw
    is bit for bit JAX's; erfinv (taken in float64 here, a polynomial in
    float32 in XLA) may differ in the last bit."""
    import torch
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape) * np.float32(2.0) + lo
    u = np.maximum(lo, u)
    e = torch.erfinv(torch.as_tensor(u, dtype=torch.float64)).numpy()
    return (np.float32(np.sqrt(2.0)) * e.astype(np.float32)).astype(np.float32)
