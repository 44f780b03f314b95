"""The counter hash of the paper's operators and of the fused sweep, in plain torch.

Frozen copy of ``src/repro_torch/core/rng.py`` (``mul32``, ``_lowbias32``,
``counter_hash_words``, ``plane_base``, ``plane_word``, ``PLANE_SALTS``) and of
its threshold rule (``threshold_from_p``): the benchmark's yardstick, which
later changes to the program do not move.  Values are int64 tensors in
``[0, 2**32)``; a product of two 32-bit values is split into 16-bit halves so
that no intermediate leaves int64.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
PLANE_SALTS = (
    0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x165667B1,
    0x9E3779B9, 0xFF51AFD7, 0xC4CEB9FE, 0x2545F497,
)


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in ``[0, 2**32)`` and a 32-bit ``c``."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def lowbias32(x: torch.Tensor) -> torch.Tensor:
    """The lowbias32 avalanche hash on int64 values."""
    x = x & MASK32
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def word_hash(ctr: torch.Tensor, kd0: int, kd1: int) -> torch.Tensor:
    """Entropy word of each counter: ``lowbias32(lowbias32(ctr ^ kd0) ^ kd1)``."""
    return lowbias32(lowbias32((ctr & MASK32) ^ (kd0 & MASK32)) ^ (kd1 & MASK32))


def plane_words(ctr: torch.Tensor, kd0: int, kd1: int) -> torch.Tensor:
    """``ctr.shape + (8,)`` bit-plane words of the fused sweep at each counter:
    plane ``k`` is ``lowbias32(lowbias32(ctr ^ kd0) ^ PLANE_SALTS[k] ^ kd1)``."""
    base = lowbias32((ctr & MASK32) ^ (kd0 & MASK32))
    return torch.stack([lowbias32(base ^ ((s ^ kd1) & MASK32)) for s in PLANE_SALTS], dim=-1)


def thresholds(p: torch.Tensor) -> torch.Tensor:
    """8-bit DAC thresholds ``round(p * 256)`` (half to even), clipped to [0, 256], int64."""
    return torch.clamp(torch.round(p.to(torch.float32) * 256.0), 0.0, 256.0).to(torch.int64)


def seed_words(key) -> tuple:
    """The two 32-bit words of a key given as a (2,) uint32 array."""
    return int(key[0]) & MASK32, int(key[1]) & MASK32
