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

:func:`random_bits`, :func:`uniform` and :func:`randint` draw what
``jax.random.bits``, ``uniform`` (float32) and ``randint`` (int32) draw from
the same key, bit for bit, under either layout; they run the same cipher
over numpy uint32 arrays of counters.
"""

from __future__ import annotations

import numpy as np

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: int, k1: int, x0, x1) -> tuple:
    """The Threefry-2x32 block cipher of counter pairs under key (k0, k1).

    ``x0``/``x1`` are Python ints (one pair) or uint32 numpy arrays (one pair
    per element): every add and rotate is masked to 32 bits, which wraps the
    ints and leaves the arrays' own uint32 wrap as it is.
    """
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


# ------------------------------------------------------------------ sampling
def random_bits(key, shape=(), *, partitionable: bool = True) -> np.ndarray:
    """``jax.random.bits(key, shape)``: uint32 words, row-major over ``shape``.

    The partitionable layout hashes the 64-bit flat index ``i`` as the counter
    pair ``(i >> 32, i & 0xFFFFFFFF)`` and XORs the two output words; the
    original layout hashes the counters ``0 .. n-1`` split into two halves (a
    zero appended when ``n`` is odd) and concatenates the two output halves.
    """
    shape = tuple(int(d) for d in shape)
    n = int(np.prod(shape, dtype=np.int64))
    k0, k1 = (int(w) for w in _key(key))
    if n == 0:
        return np.zeros(shape, np.uint32)
    with np.errstate(over="ignore"):
        if partitionable:
            idx = np.arange(n, dtype=np.uint64)
            hi, lo = (idx >> np.uint64(32)).astype(np.uint32), idx.astype(np.uint32)
            a, b = threefry2x32(k0, k1, hi, lo)
            return (a ^ b).reshape(shape)
        if n >= _MASK:
            raise NotImplementedError("the original layout draws fewer than 2**32 - 1 words")
        count = np.arange(n + (n % 2), dtype=np.uint32)
        if n % 2:
            count[-1] = 0
        half = count.shape[0] // 2
        a, b = threefry2x32(k0, k1, count[:half], count[half:])
        return np.concatenate([a, b])[:n].reshape(shape)


def uniform(key, shape=(), *, partitionable: bool = True) -> np.ndarray:
    """``jax.random.uniform(key, shape)`` in [0, 1): float32, bit for bit.

    The top 23 bits of each word become the mantissa of a float in [1, 2),
    and 1 is subtracted.
    """
    bits = random_bits(key, shape, partitionable=partitionable)
    one = np.uint32(0x3F800000)
    return ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)


_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


def randint(key, shape, minval: int, maxval: int, *, partitionable: bool = True) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` as int32, bit for bit.

    As the reference: the key is split in two for a high and a low word per
    value, and ``(hi % span * m + lo % span) % span`` offsets ``minval``, in
    uint32 arithmetic that wraps, with ``m = (2**16 % span)**2 % span`` (whose
    square wraps too, so ``m`` is 0 for every span above 2**16).  A range with
    ``maxval <= minval`` returns ``minval``.  Ends outside int32 raise
    ``OverflowError``, as the reference's do.
    """
    lo_v, hi_v = int(minval), int(maxval)
    for v in (lo_v, hi_v):
        if not _I32_MIN <= v <= _I32_MAX:
            raise OverflowError(f"randint range end {v} is outside int32")
    span = hi_v - lo_v if hi_v > lo_v else 1
    k_hi, k_lo = split(key, 2, partitionable=partitionable)
    higher = random_bits(k_hi, shape, partitionable=partitionable).astype(np.uint64)
    lower = random_bits(k_lo, shape, partitionable=partitionable).astype(np.uint64)
    mult = ((2**16 % span) ** 2 & _MASK) % span
    offset = (((higher % span) * mult + lower % span) & _MASK) % span
    return ((lo_v + offset.astype(np.int64)) & _MASK).astype(np.uint32).view(np.int32)
