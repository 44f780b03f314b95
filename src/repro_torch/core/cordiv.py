"""CORDIV -- correlated stochastic divider (Chen & Hayes 2016; paper Figs S7/S9/S10).

The circuit: ``q_t = d_t ? n_t : DFF``, where the D-flip-flop holds the last
quotient bit emitted while the divisor was high.  When the numerator stream
is a bitwise subset of the denominator stream, E[q] -> P(n) / P(d).

* :func:`cordiv_scan`  -- the bit-serial circuit, one step per stream bit
  (the oracle of the fast path).
* :func:`cordiv_fill`  -- word-parallel: each quotient bit copies ``n`` at the
  most recent position where ``d`` was high.  SWAR jump-doubling inside each
  32-bit word; across words the held bit is the top bit of the last word
  whose ``d`` is non-zero, found for all words at once with a running
  maximum of word indices (the reference carries it with ``lax.scan``).
  Bit-identical to ``cordiv_scan``.
* :func:`cordiv_ratio` -- the closed-form fixed point
  ``popcount(n & d) / popcount(d)``.
* :func:`make_superset` -- a denominator stream built around a numerator,
  so that the subset CORDIV needs holds bitwise.

Words are int32 bit patterns (:mod:`repro_torch.core.bitops`); int32 ``<<``
wraps and ``(v >> 31) & 1`` reads the top bit, so no int64 carrier is needed.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitops, sne


def ratio_from_counts(numer_count, denom_count) -> torch.Tensor:
    """float32 ``numer / denom`` of integer counts, 0 at 0/0.

    The single home of the zero-denominator convention.  Integer counts below
    ``2**24`` are exact in float32, so the quotient is the correctly rounded
    float32 of the exact ratio on every backend.
    """
    num = torch.as_tensor(numer_count).to(torch.float32)
    den = torch.as_tensor(denom_count).to(torch.float32)
    return torch.where(den > 0, num / torch.clamp(den, min=1.0),
                       torch.zeros((), dtype=torch.float32, device=num.device))


def cordiv_scan(numer: torch.Tensor, denom: torch.Tensor, n_bits: int):
    """Bit-serial CORDIV over packed streams -> (quotient words, estimate)."""
    numer, denom = torch.broadcast_tensors(numer, denom)
    nb = bitops.unpack_bits(numer, n_bits)
    db = bitops.unpack_bits(denom, n_bits)
    dff = torch.zeros(nb.shape[:-1], dtype=torch.uint8, device=nb.device)
    q = torch.empty_like(nb)
    for t in range(n_bits):
        dff = torch.where(db[..., t] == 1, nb[..., t], dff)
        q[..., t] = dff
    qpacked = bitops.pack_bits(q)
    return qpacked, bitops.decode(qpacked, n_bits)


def _fill_last_set(m: torch.Tensor, d: torch.Tensor):
    """SWAR last-set-bit fill within each 32-bit word, LSB-first.

    For every bit position t, propagate the value ``m`` holds at the most
    recent position <= t where ``d`` is set.  Returns (val, known): the
    filled word (0 where ``d`` has no set bit yet in the word) and the
    prefix-OR of ``d``.  After the round with shift s every position within
    2s of its source is resolved, so 5 rounds cover the word.
    """
    val, known = m, d
    for s in (1, 2, 4, 8, 16):
        shifted_known = known << s
        take = shifted_known & ~known
        val = val | ((val << s) & take)
        known = known | shifted_known
    return val, known


def cordiv_fill(numer: torch.Tensor, denom: torch.Tensor, n_bits: int):
    """Word-parallel CORDIV, bit-identical to :func:`cordiv_scan`.

    Returns (quotient words, estimate).  Leading axes broadcast.
    """
    numer, denom = torch.broadcast_tensors(numer, denom)
    val, known = _fill_last_set(numer & denom, denom)
    # the held bit entering word w: bit 31 of the filled word at the last
    # word before w whose d is non-zero (0 when there is none)
    nw = denom.shape[-1]
    idx = torch.arange(nw, device=denom.device).expand(denom.shape)
    last = torch.where(denom != 0, idx, torch.full_like(idx, -1))
    last = torch.cummax(last, dim=-1).values
    prev = torch.cat([torch.full_like(last[..., :1], -1), last[..., :-1]], dim=-1)
    top = (val >> 31) & 1
    carry = torch.where(prev >= 0, torch.gather(top, -1, prev.clamp(min=0)),
                        torch.zeros_like(top))
    q = val | torch.where(carry == 1, ~known, torch.zeros_like(known))
    qpacked = q & bitops.pad_mask(n_bits, device=q.device)
    return qpacked, bitops.decode(qpacked, n_bits)


def cordiv_ratio(numer: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """Closed-form CORDIV fixed point: popcount(n & d) / popcount(d), 0 at 0/0."""
    return ratio_from_counts(bitops.popcount(numer & denom), bitops.popcount(denom))


def make_superset(key, numer: torch.Tensor, p_n, p_d, n_bits: int) -> torch.Tensor:
    """Superset completion: a stream d with P(d) = p_d and numer subset-of d.

    ``d = numer | g``, g an independent stream of probability
    ``(p_d - p_n) / (1 - p_n)``; used where the denominator is known only
    marginally, so that CORDIV's correlation requirement still holds.  Runs
    on ``numer``'s device.
    """
    dev = numer.device
    p_n = torch.as_tensor(p_n, dtype=torch.float32, device=dev)
    p_d = torch.as_tensor(p_d, dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    p_g = torch.clamp((p_d - p_n) / torch.clamp(one - p_n, min=1e-6), 0.0, 1.0)
    return numer | sne.encode_uncorrelated(key, p_g, n_bits, device=dev)
