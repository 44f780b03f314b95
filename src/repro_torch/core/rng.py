"""Counter-based entropy for the fused sweep, in torch (DESIGN.md SS2/SS3).

The fused sweep draws its entropy as *bit-planes*: for one packed output word,
plane ``k`` is a 32-bit word whose bit ``j`` is bit ``k`` of the 8-bit
comparator byte at stream position ``j``.  A plane word is two lowbias32
avalanche rounds over a keyed counter: the first round (:func:`plane_base`) is
shared by the word's 8 planes, the second (:func:`plane_word`) is salted per
plane.  Everything is exact 32-bit integer arithmetic, so the port draws the
reference's words bit for bit.

Values travel as int64 tensors in ``[0, 2**32)``.  A product of two 32-bit
values can exceed int64, so :func:`mul32` splits the constant into 16-bit
halves: each partial product stays below ``2**48`` and the low 32 bits of the
sum are the wrapped uint32 product, with no reliance on signed overflow.

Thresholds are the 8-bit DAC grid ``round(p * 256)`` with round-half-even, as
in the reference (``p = (2k+1)/512`` sits exactly on a half step).

The paper's operators (``sne_encode``, ``bayes_decide``) draw *word* entropy
instead: :func:`counter_hash_words` runs both lowbias32 rounds over the
row-major counter of every entropy word, and each word gives 4 comparator
bytes.  :func:`packed_from_bytes` is the comparator and packer of those words,
and :func:`encode_packed` / :func:`encode_packed_categorical` the root
encoders of the unfused lowering built on them.  :func:`encode_packed_correlated`
compares one entropy source against several thresholds (the correlated SNE),
and :func:`fair_bits` takes the words themselves as p = 0.5 streams.

``impl='threefry'`` draws the words from the Threefry cipher instead
(:func:`~repro_torch.core.prng.device_bits`, ``jax.random.bits`` bit for bit)
on the same device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.bitops import MASK32, as_i32, n_words, pad_mask, value_planes

# Stream bits contributed by one 32-bit entropy word (one per byte).
BITS_PER_RAND_WORD = 4
# Entropy words consumed per packed output word (32 stream bits / 4 per word).
RAND_WORDS_PER_OUT_WORD = 8

# Dense, well-spread odd salts (xxhash/murmur/splitmix finalizer constants);
# XORed into the second keyed round to separate the 8 bit-planes of one word.
PLANE_SALTS = (
    0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x165667B1,
    0x9E3779B9, 0xFF51AFD7, 0xC4CEB9FE, 0x2545F497,
)


def threshold_int(p: float) -> int:
    """Probability -> 8-bit comparator threshold in [0, 256] (half-even)."""
    return int(np.clip(np.round(np.float32(p) * 256.0), 0.0, 256.0))


def threshold_from_p(p: torch.Tensor) -> torch.Tensor:
    """Probabilities -> int64 8-bit comparator thresholds in [0, 256].

    float32 ``p * 256`` is exact and ``torch.round`` rounds half to even, as
    ``jnp.round`` does.
    """
    p = torch.as_tensor(p, dtype=torch.float32)
    return torch.clamp(torch.round(p * 256.0), 0.0, 256.0).to(torch.int64)


def cdf_thresholds_int(probs) -> tuple:
    """Per-value probabilities ``(p_0, .., p_{k-1})`` -> ``(k-1,)`` cumulative
    8-bit DAC thresholds.

    Threshold ``C_v`` encodes ``P(value >= v)``: one entropy byte samples the
    whole categorical draw as ``value = #{v : byte < C_v}``.  Tail sums are
    non-increasing, so the rounded thresholds are too (enforced defensively).
    For k=2 the single threshold is :func:`threshold_int` of ``P(value=1)``.
    """
    k = len(probs)
    if k < 2:
        raise ValueError(f"need >= 2 value probabilities, got {k}")
    out = []
    prev = 256
    for v in range(1, k):
        tail = float(np.sum(np.asarray(probs[v:], np.float64)))
        t = min(threshold_int(tail), prev)
        out.append(t)
        prev = t
    return tuple(out)


def n_rand_words(n_bits: int) -> int:
    """32-bit entropy words needed for ``n_bits`` stream bits (word-padded)."""
    return n_words(n_bits) * RAND_WORDS_PER_OUT_WORD


def seed_words(key) -> tuple:
    """The two 32-bit seed words of a key (``prng`` key data) as Python ints."""
    kd = np.asarray(key, np.uint32).reshape(-1)
    return int(kd[0]), int(kd[1])


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in ``[0, 2**32)`` and a 32-bit ``c``."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _lowbias32(x: torch.Tensor) -> torch.Tensor:
    """Full-avalanche 32-bit integer hash (lowbias32) on int64 values."""
    x = x & MASK32
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def plane_base(ctr: torch.Tensor, kd0: int) -> torch.Tensor:
    """First avalanche round over keyed counters, shared by a word's 8 planes."""
    return _lowbias32((ctr & MASK32) ^ (kd0 & MASK32))


def plane_word(base: torch.Tensor, kd1: int, plane: int) -> torch.Tensor:
    """Second keyed round: one word of fair bits for bit-plane ``plane``."""
    return _lowbias32(base ^ ((PLANE_SALTS[plane] ^ kd1) & MASK32))


def counter_iota(shape: tuple, offset: int = 0, device=None) -> torch.Tensor:
    """Row-major flat counters of ``shape`` plus ``offset``, mod 2**32 (int64).

    Each axis adds ``arange * stride`` at the output shape, so no flat 1-D
    intermediate is built.  The sum is taken in int64 (exact below 2**63)
    and wrapped once, which equals the reference's uint32 iota sums.
    """
    shape = tuple(int(d) for d in shape)
    ctr = torch.tensor(int(offset) & MASK32, dtype=torch.int64, device=device)
    stride = 1
    for axis in reversed(range(len(shape))):
        view = [1] * len(shape)
        view[axis] = shape[axis]
        iota = torch.arange(shape[axis], dtype=torch.int64, device=device)
        ctr = ctr + (iota * stride).view(view)
        stride *= shape[axis]
    return ctr.expand(shape) & MASK32


def counter_hash_words(key, shape: tuple, n_words: int, *, offset: int = 0,
                       device=None) -> torch.Tensor:
    """``shape + (n_words,)`` entropy words (int64 in [0, 2**32)).

    Word ``i`` is ``lowbias32(lowbias32(ctr_i ^ kd0) ^ kd1)`` where ``ctr_i``
    is its row-major flat index plus ``offset``, mod 2**32 -- the reference's
    generator bit for bit, and what the CUDA operators compute in-kernel.
    """
    kd0, kd1 = seed_words(key)
    ctr = counter_iota(tuple(shape) + (int(n_words),), offset, device)
    return _lowbias32(_lowbias32(ctr ^ kd0) ^ kd1)


def packed_from_bytes(rand: torch.Tensor, thresh, flip=None) -> torch.Tensor:
    """Byte-threshold compare and pack: the SNE comparator, packed.

    rand:   (..., n_rand) int64 entropy words in [0, 2**32), n_rand % 8 == 0.
    thresh: int64 thresholds in [0, 256], broadcastable to ``rand.shape[:-1]``.
    flip:   optional bool mask (same broadcast): streams whose comparator is
            complemented (byte -> 255 - byte).

    Returns (..., n_rand // 8) int32 packed words.  Stream bit ``4r + b``
    comes from byte ``b`` of entropy word ``r``; it lands in output word
    ``r // 8`` at bit ``4 * (r % 8) + b`` (the interleaved layout of the
    ``sne_encode`` kernel, not natural bit order).
    """
    n_rand = rand.shape[-1]
    if n_rand % RAND_WORDS_PER_OUT_WORD:
        raise ValueError(f"n_rand must be a multiple of 8, got {n_rand}")
    thresh = torch.as_tensor(thresh, dtype=torch.int64, device=rand.device)[..., None]
    if flip is not None:
        flip = torch.as_tensor(flip, dtype=torch.bool, device=rand.device)[..., None]
    shifts = torch.arange(8, dtype=torch.int64, device=rand.device) * 4
    acc = None
    for byte in range(BITS_PER_RAND_WORD):
        lane = (rand >> (8 * byte)) & 0xFF
        if flip is not None:
            lane = torch.where(flip, 0xFF - lane, lane)
        bits = (lane < thresh).to(torch.int64)
        grouped = bits.reshape(bits.shape[:-1] + (n_rand // 8, 8))
        word = (grouped << (shifts + byte)).sum(-1)
        acc = word if acc is None else acc | word
    return as_i32(acc)


# --- the unfused lowering's root encoders ---------------------------------------

def _mask_tail(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Zero the pad bits when n_bits is not word-aligned (popcount invariant)."""
    if n_bits % 32:
        return words & pad_mask(n_bits, device=words.device)
    return words


def _draw_words(key, shape: tuple, impl: str, device) -> torch.Tensor:
    """``shape`` entropy words (int64) from the generator ``impl`` names."""
    if impl == "threefry":
        return prng.device_bits(key, shape, device=device or "cpu")
    if impl != "fast":
        raise ValueError(f"impl must be 'fast' or 'threefry', got {impl!r}")
    return counter_hash_words(key, shape[:-1], shape[-1], device=device)


def random_words(key, shape: tuple, n_bits: int, impl: str = "fast", *,
                 device=None) -> torch.Tensor:
    """``shape + (n_rand,)`` entropy words for ``n_bits``-bit streams (int64).

    ``impl='fast'`` is the counter-hash generator, ``impl='threefry'`` the
    Threefry cipher of ``jax.random.bits``; both on ``device``.
    """
    return _draw_words(key, tuple(shape) + (n_rand_words(n_bits),), impl, device)


def encode_packed(key, p, n_bits: int, impl: str = "fast") -> torch.Tensor:
    """Independent packed Bernoulli streams: ``p.shape + (n_words,)`` int32.

    Runs on ``p``'s device.  Entry ``i`` of the flattened ``p`` draws the
    counters ``i * n_rand ..``, as the ``sne_encode`` kernel does.
    """
    p = torch.as_tensor(p, dtype=torch.float32)
    rand = random_words(key, tuple(p.shape), n_bits, impl, device=p.device)
    return _mask_tail(packed_from_bytes(rand, threshold_from_p(p)), n_bits)


def encode_packed_correlated(key, p, n_bits: int, negate=None, impl: str = "fast") -> torch.Tensor:
    """Packed streams over the trailing axis of ``p`` sharing one entropy source.

    Every stream of the group compares the *same* bytes against its own
    threshold (one SNE, many comparator references): maximal positive
    correlation.  ``negate`` marks streams read through the complemented
    comparator (``255 - byte``): maximal negative correlation with the
    others.  Runs on ``p``'s device.
    """
    p = torch.as_tensor(p, dtype=torch.float32)
    rand = random_words(key, tuple(p.shape[:-1]) + (1,), n_bits, impl, device=p.device)
    flip = None if negate is None else torch.as_tensor(negate, dtype=torch.bool,
                                                        device=p.device)
    return _mask_tail(packed_from_bytes(rand, threshold_from_p(p), flip), n_bits)


def encode_packed_categorical(key, cdf: tuple, n_bits: int, batch: int | None = None,
                              impl: str = "fast", *, device=None) -> torch.Tensor:
    """Categorical root sampling: one entropy byte -> ``value_bits(k)`` planes.

    cdf: ``(k-1,)`` non-increasing cumulative thresholds in [0, 256]
    (:func:`cdf_thresholds_int`).  Draws the entropy a binary
    :func:`encode_packed` of the same shape draws and compares each byte with
    every threshold.  Returns ``(value_bits(k), n_words)`` int32, or
    ``(value_bits(k), batch, n_words)`` when ``batch`` is given.
    """
    lead = () if batch is None else (batch,)
    rand = random_words(key, lead, n_bits, impl, device=device)
    levels = [packed_from_bytes(rand, int(t)) for t in cdf]
    return torch.stack([_mask_tail(pl, n_bits) for pl in value_planes(levels)])


def fair_bits(key, shape: tuple, n_bits: int, impl: str = "fast", *,
              device=None) -> torch.Tensor:
    """p = 0.5 packed streams straight from the generator: ``shape + (n_words,)``
    int32, one entropy bit per stream bit, pad bits zeroed.

    The MUX tree's selects are fair coins, so they skip the byte compare.
    ``impl`` chooses the generator as in :func:`random_words`.
    """
    words = _draw_words(key, tuple(shape) + (n_words(n_bits),), impl, device)
    return _mask_tail(as_i32(words), n_bits)
