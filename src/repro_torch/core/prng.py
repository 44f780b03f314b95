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
over numpy uint32 arrays of counters on the host, for key derivation and
small draws.

Bulk draws run on a device: :func:`device_bits` and :func:`device_uniform`
run the same cipher over int64 torch tensors of counters (every add and
rotate masked to 32 bits, as above), bit for bit, and :func:`normal` is
``jax.random.normal``: a uniform on ``[nextafter(-1, 0), 1)`` times
``sqrt(2)`` through :func:`erf_inv`.  ``torch.erfinv`` is not XLA's
``erf_inv`` (on a million float32 inputs they differ on two thirds of the
values, by up to 63 ulp); :func:`erf_inv` is XLA's float32 polynomial
(Giles' approximation, the ``w < 5`` / ``w >= 5`` branches of ``ErfInv32``)
with the same order of operations, and differs from it only through the
platforms' ``log1p``, by at most a few ulp.  Its ``sqrt`` is taken in
float64 and rounded once, which is the correctly rounded float32 root on
every device: torch's float32 ``sqrt`` on the CPU is not, and its result
there has been seen to change between runs and with the thread count.
"""

from __future__ import annotations

import numpy as np
import torch

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


# ------------------------------------------------------------ device draws
def _key_words(keys, device) -> tuple:
    """``(..., 2)`` key data -> two int64 tensors of shape ``(...)`` on ``device``."""
    kd = torch.from_numpy(np.asarray(keys, np.uint32).astype(np.int64)).to(device)
    return kd[..., 0], kd[..., 1]


def device_bits(keys, shape=(), *, device="cuda", partitionable: bool = True) -> torch.Tensor:
    """:func:`random_bits` on ``device``: int64 words in ``[0, 2**32)``.

    ``keys`` is one key (``(2,)``) or a batch of keys (``(..., 2)``); the
    result has the batch's leading axes, then ``shape``, and row ``i`` is
    what ``jax.random.bits(keys[i], shape)`` draws.  The counters and the
    cipher run on ``device``; only the key words travel.
    """
    from repro_torch.kernels.backend import resolve_device

    dev = resolve_device(device)
    shape = tuple(int(d) for d in shape)
    n = int(np.prod(shape, dtype=np.int64))
    k0, k1 = _key_words(keys, dev)
    lead = tuple(k0.shape)
    if n == 0:
        return torch.zeros(lead + shape, dtype=torch.int64, device=dev)
    k0, k1 = k0.reshape(lead + (1,)), k1.reshape(lead + (1,))
    if partitionable:
        idx = torch.arange(n, dtype=torch.int64, device=dev)
        a, b = threefry2x32(k0, k1, idx >> 32, idx & _MASK)
        return (a ^ b).reshape(lead + shape)
    if n >= _MASK:
        raise NotImplementedError("the original layout draws fewer than 2**32 - 1 words")
    count = torch.arange(n + (n % 2), dtype=torch.int64, device=dev)
    if n % 2:
        count[-1] = 0
    half = count.shape[0] // 2
    a, b = threefry2x32(k0, k1, count[:half], count[half:])
    return torch.cat([a, b], dim=-1)[..., :n].reshape(lead + shape)


def _unit_floats(words: torch.Tensor) -> torch.Tensor:
    """int64 words -> float32 in [0, 1): the top 23 bits as the mantissa of
    a float in [1, 2), minus 1 (exact)."""
    f = ((words >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - torch.ones((), dtype=torch.float32, device=f.device)


def device_uniform(keys, shape=(), *, device="cuda", partitionable: bool = True) -> torch.Tensor:
    """:func:`uniform` on ``device`` (float32 in [0, 1), bit for bit)."""
    return _unit_floats(device_bits(keys, shape, device=device, partitionable=partitionable))


def device_uniform_range(keys, shape, minval: float, maxval: float, *, device="cuda",
                         partitionable: bool = True) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``, bit for bit.

    The reference's compiled draw is ``max(lo, u * (hi - lo) + lo)`` with the
    multiply-add contracted into one FMA; the float32 product is exact in
    float64 and so is the sum (it needs at most 48 bits when ``|lo|, |hi| <=
    1``), so one rounding of the float64 result is that FMA on every device.
    """
    if max(abs(minval), abs(maxval)) > 1.0:
        raise ValueError("the float64 emulation of the FMA is exact for |bounds| <= 1 only")
    u = device_uniform(keys, shape, device=device, partitionable=partitionable)
    lo = torch.tensor(np.float32(minval), device=u.device)
    span = torch.tensor(np.float32(maxval), device=u.device) - lo
    return torch.maximum(lo, (u.double() * span.double() + lo.double()).float())


# XLA's float32 inverse error function (Giles' approximation), coefficients
# of the w < 5 and w >= 5 branches, highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``, operation for operation, on ``x``'s device.

    ``w = -log1p(-x * x)``; below 5 the polynomial runs in ``w - 2.5``, else
    in ``sqrt(w) - 3`` (the root correctly rounded, through float64); the
    result is ``p(w) * x``, and ``+-inf`` at ``|x| == 1``.
    """
    x = torch.as_tensor(x, dtype=torch.float32)

    def f32(v):
        return torch.tensor(np.float32(v), device=x.device)

    w = -torch.log1p(x * -x)
    lt = w < f32(5.0)
    w = torch.where(lt, w - f32(2.5), torch.sqrt(w.double()).float() - f32(3.0))
    p = None
    for lo, hi in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(lt, f32(lo), f32(hi))
        p = c if p is None else c + p * w
    inf = f32(np.inf)
    return torch.where(x.abs() == f32(1.0), x * inf, p * x)


def normal(keys, shape=(), *, device="cuda", partitionable: bool = True) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (float32) on ``device``.

    The uniform on ``[lo, 1)``, ``lo = nextafter(-1, 0)``, is the unit draw
    times ``1 - lo`` plus ``lo``, floored at ``lo``; the normal is
    ``sqrt(2) * erf_inv(u)``.  Equal to the reference's draw within a few
    ulp (the platforms' ``log1p`` rounds differently).
    ``keys`` may be a batch, as for :func:`device_bits`.
    """
    u01 = device_uniform(keys, shape, device=device, partitionable=partitionable)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    lo_t = torch.tensor(lo, device=u01.device)
    scale = torch.tensor(np.float32(1.0) - lo, device=u01.device)
    u = torch.maximum(lo_t, u01 * scale + lo_t)
    return torch.tensor(np.float32(np.sqrt(2)), device=u.device) * erf_inv(u)
