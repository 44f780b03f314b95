"""Threefry-2x32 key lineage on the host, matching ``jax.random``'s keys.

The serving driver derives every launch key from a base key by ``fold_in``
(driver salt, launch counter) and ``split`` (explicit key streams).  Only the
two 32-bit words of a key ever reach the device (the sweep's ``kd0``/``kd1``),
so the port carries keys as ``(2,)`` uint32 numpy arrays -- the reference's
``key_data`` -- and runs Threefry-2x32 (Salmon et al., SC'11; 20 rounds) in
plain Python integers.  The same base key and salt then give the reference's
launch keys word for word.

``split`` follows the reference's default key layout (the "partitionable"
Threefry mode, default since jax 0.5): key ``i`` of a split is the block
cipher of the counter pair ``(0, i)``.  ``partitionable=False`` gives the
older layout, in which the ``2*num`` outputs of counters ``0 .. 2*num-1`` are
reshaped into ``num`` keys.
"""

from __future__ import annotations

import numpy as np

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: int, k1: int, x0: int, x1: int) -> tuple:
    """The Threefry-2x32 block cipher of one counter pair under key (k0, k1)."""
    ks = (k0 & _MASK, k1 & _MASK, (k0 ^ k1 ^ _PARITY) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _key(words) -> np.ndarray:
    return np.asarray(words, np.uint32).reshape(2)


def PRNGKey(seed: int) -> np.ndarray:
    """Key data of ``jax.random.PRNGKey(seed)`` for a 32-bit seed."""
    return _key((0, int(seed) & _MASK))


def key_data(key) -> np.ndarray:
    """The ``(2,)`` uint32 words of a key (keys are their data here)."""
    return _key(key)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in``: the block cipher of ``(0, data)`` under ``key``."""
    k = _key(key)
    return _key(threefry2x32(int(k[0]), int(k[1]), 0, int(data) & _MASK))


def split(key, num: int = 2, *, partitionable: bool = True) -> np.ndarray:
    """``jax.random.split`` -> ``(num, 2)`` uint32 key data."""
    k0, k1 = (int(w) for w in _key(key))
    if partitionable:
        keys = [threefry2x32(k0, k1, 0, i) for i in range(num)]
        return np.asarray(keys, np.uint32).reshape(num, 2)
    outs = [threefry2x32(k0, k1, i, num + i) for i in range(num)]
    flat = [o[0] for o in outs] + [o[1] for o in outs]
    return np.asarray(flat, np.uint32).reshape(num, 2)
