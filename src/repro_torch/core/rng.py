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
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bitops import MASK32

# Dense, well-spread odd salts (xxhash/murmur/splitmix finalizer constants);
# XORed into the second keyed round to separate the 8 bit-planes of one word.
PLANE_SALTS = (
    0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x165667B1,
    0x9E3779B9, 0xFF51AFD7, 0xC4CEB9FE, 0x2545F497,
)


def threshold_int(p: float) -> int:
    """Probability -> 8-bit comparator threshold in [0, 256] (half-even)."""
    return int(np.clip(np.round(np.float32(p) * 256.0), 0.0, 256.0))


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
