"""Packed 32-bit stream words in torch, and the categorical bit-plane helpers.

A stochastic number of ``n_bits`` stream bits is carried as ``n_words =
ceil(n_bits / 32)`` words, LSB-first within each word (DESIGN.md SS2).  torch
has no unsigned 32-bit shift, and its int32 ``>>`` sign-extends, so the port
keeps two representations and converts explicitly:

* **int32 words** hold the bit pattern for the logic gates: ``&``, ``|``,
  ``^`` and ``~`` act on all 32 bits alike whatever the sign, so a word's bits
  are exactly the reference's uint32 bits.
* **int64 words in [0, 2**32)** carry the arithmetic (shifts, multiplies,
  popcount), masked back to 32 bits after every step that can grow them.

The categorical helpers (:func:`nested_buckets`, :func:`planes_from_buckets`,
:func:`digit_indicator`) use only the gate operators, so they run unchanged on
int32 tensors and on the symbolic words of the gate-program recorder.
"""

from __future__ import annotations

import torch

WORD = 32
MASK32 = 0xFFFFFFFF


def n_words(n_bits: int) -> int:
    """Number of 32-bit words needed to hold ``n_bits`` stream bits."""
    return -(-n_bits // WORD)


def as_u32(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in ``[0, 2**32)``."""
    return words.to(torch.int64) & MASK32


def as_i32(values: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` -> int32 words with the same 32 bits."""
    values = values & MASK32
    return (values - ((values >> 31) << 32)).to(torch.int32)


def pad_mask(n_bits: int, device=None) -> torch.Tensor:
    """(n_words,) int32 word mask with ones on valid bit positions.

    Built by fills on ``device``: no host-to-device copy, so building it
    never waits on the stream.
    """
    full, rem = divmod(n_bits, WORD)
    mask = torch.full((n_words(n_bits),), -1, dtype=torch.int32, device=device)
    if rem:
        mask[full] = (1 << rem) - 1
    return mask


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """SWAR popcount per 32-bit word (int32 or int64 input) -> int32 counts."""
    x = as_u32(words) if words.dtype != torch.int64 else words & MASK32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & MASK32) >> 24).to(torch.int32)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Total set bits along the trailing word axis -> (...,) int32."""
    return popcount_words(words).sum(dim=-1, dtype=torch.int32)


# --- categorical value bit-planes (DESIGN.md §10) ----------------------------------

def value_bits(k: int) -> int:
    """Packed bit-planes needed to carry a cardinality-``k`` value (>= 1)."""
    if k < 2:
        raise ValueError(f"cardinality must be >= 2, got {k}")
    return (k - 1).bit_length()


def nested_buckets(levels):
    """Nested ``value >= v`` indicators -> exclusive ``value == v`` words.

    ``levels[v-1]`` is the indicator of ``value >= v`` (v = 1..k-1); returns
    the k-1 indicators of ``value == v``.  For k=2 this is ``levels`` itself.
    """
    k = len(levels) + 1
    return [levels[v - 1] if v == k - 1 else levels[v - 1] & ~levels[v]
            for v in range(1, k)]


def planes_from_buckets(buckets):
    """Exclusive value buckets (v = 1..k-1) -> ``value_bits(k)`` bit-planes."""
    k = len(buckets) + 1
    planes = []
    for b in range(value_bits(k)):
        sel = [buckets[v - 1] for v in range(1, k) if (v >> b) & 1]
        acc = sel[0]
        for s in sel[1:]:
            acc = acc | s
        planes.append(acc)
    return planes


def digit_indicator(planes, d: int):
    """Indicator word of ``value == d`` from its value bit-planes.

    For a single-plane variable the d=0 literal complements pad bits too;
    AND the result into a pad-masked acceptance word before popcounting.
    """
    acc = None
    for b, pl in enumerate(planes):
        lit = pl if (d >> b) & 1 else ~pl
        acc = lit if acc is None else acc & lit
    return acc


# --- packing and the bitwise gates of the unfused lowering -------------------------

def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a (..., n) bool/int tensor into (..., ceil(n/32)) int32 words, LSB-first."""
    n = bits.shape[-1]
    nw = n_words(n)
    b = bits.to(torch.int64)
    pad = nw * WORD - n
    if pad:
        b = torch.cat([b, b.new_zeros(b.shape[:-1] + (pad,))], dim=-1)
    b = b.reshape(b.shape[:-1] + (nw, WORD))
    shifts = torch.arange(WORD, dtype=torch.int64, device=b.device)
    return as_i32((b << shifts).sum(-1))


def unpack_bits(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Unpack (..., n_words) words into (..., n_bits) uint8 in {0, 1}."""
    shifts = torch.arange(WORD, dtype=torch.int64, device=words.device)
    bits = (as_u32(words)[..., None] >> shifts) & 1
    flat = bits.reshape(words.shape[:-1] + (words.shape[-1] * WORD,))
    return flat[..., :n_bits].to(torch.uint8)


def decode(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """A packed stochastic number's probability estimate: float32 popcount / n_bits."""
    # a tensor divisor: CUDA torch multiplies by a Python scalar's reciprocal
    return popcount(words).to(torch.float32) / torch.full(
        (), n_bits, dtype=torch.float32, device=words.device)


def band(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a & b


def bor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a | b


def bxor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a ^ b


def bnot(a: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Bitwise NOT restricted to the valid bit positions (padding stays zero)."""
    return ~a & pad_mask(n_bits, device=a.device)


def bmux(select: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-bit 2:1 MUX: ``out_t = select_t ? b_t : a_t`` (the paper's weighted adder)."""
    return (select & b) | (~select & a)


def value_planes(levels):
    """Nested ``value >= v`` indicators -> binary value bit-planes."""
    return planes_from_buckets(nested_buckets(levels))
