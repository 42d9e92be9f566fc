"""The counter-based Threefry-2x32 generator in numpy, bit for bit the
draws of the JAX package's default generator (``threefry2x32`` with
``jax_threefry_partitionable``, the default since JAX 0.5): a key from a
seed, ``split`` and ``uniform``. The KG triple embeddings draw their
initial tables with it, so that a seed starts from the JAX package's
tables (``models/emb/knowledge_base.py``)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

Key = Tuple[np.uint32, np.uint32]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def threefry2x32(key: Key, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 (20 rounds) of the counter pairs ``(x0, x1)``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> Key:
    """The key of ``jax.random.PRNGKey(seed)``."""
    return (np.uint32((seed >> 32) & 0xFFFFFFFF),
            np.uint32(seed & 0xFFFFFFFF))


def _bits(key: Key, n: int):
    # the 64-bit counters 0 .. n - 1 as (high, low) words
    return threefry2x32(key, np.zeros(n, np.uint32),
                        np.arange(n, dtype=np.uint32))


def split(key: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(key, num)``."""
    b0, b1 = _bits(key, num)
    return list(zip(b0, b1))


def uniform(key: Key, shape, minval: float, maxval: float) -> np.ndarray:
    """``jax.random.uniform(key, shape, minval=minval, maxval=maxval)`` in
    float32: the mantissa from the high 23 of 32 random bits, scaled with
    one rounding (XLA fuses the multiply and add)."""
    b0, b1 = _bits(key, int(np.prod(shape)))
    bits = ((b0 ^ b1) >> np.uint32(9)) | np.uint32(0x3F800000)
    unit = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    scaled = (unit.astype(np.float64) * np.float64(hi - lo)
              + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled).reshape(shape)
