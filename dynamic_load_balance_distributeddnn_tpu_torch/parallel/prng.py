"""JAX's threefry2x32 keys on the host, for scalars (numpy, no JAX).

The compressed collectives seed their dither from JAX keys
(``parallel/wire.py`` ``_dither`` reads ``key_data``): the fused path's
``fold_in(fold_in(fold_in(PRNGKey(0), seed), idx), step)`` and the elastic
combine's ``fold_in(fold_in(PRNGKey(0x5D1E), idx), step)``. These are
``jax.random.PRNGKey``, ``fold_in`` and ``key_data`` of the default
threefry implementation for scalar seeds and data, so the port's dither
seeds equal the JAX package's. A key is a ``(k0, k1)`` pair of Python ints
below 2**32.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

Key = Tuple[int, int]
_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: Key, x0, x1) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash of count pairs (uint32 arrays; 20 rounds), as
    JAX's unrolled lowering computes it. uint32 arrays wrap mod 2**32."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, dtype=np.uint32) + ks[0], np.asarray(x1, dtype=np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``threefry_seed``'s
    ``(seed >> 32, seed & M)`` of the 32-bit value, so the high word is 0."""
    return 0, int(seed) & _M


def fold_in_many(key: Key, data: Sequence[int]) -> List[Key]:
    """``[jax.random.fold_in(key, d) for d in data]``: the hash of
    ``threefry_seed(d)`` (``d`` as uint32, so ``(0, d)``) under ``key``."""
    d = np.array([int(v) & _M for v in data], dtype=np.uint32)
    a, b = threefry2x32(key, np.zeros_like(d), d)
    return [(int(x), int(y)) for x, y in zip(a, b)]


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    return fold_in_many(key, [data])[0]


def key_data(key: Key) -> Tuple[int, int]:
    """``jax.random.key_data(key)``: the key's two uint32 words."""
    return int(key[0]) & _M, int(key[1]) & _M
