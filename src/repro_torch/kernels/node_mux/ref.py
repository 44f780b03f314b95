"""Plain torch versions of the node-MUX sweep (one network node per launch).

``cat_gather_body`` / ``node_mux_cat_ref`` carry the categorical (k-ary)
gather; two binary formulations sample the same conditional Bernoulli:

* ``node_mux_ref`` (row-encode): encode the ``2**m`` CPT rows as independent
  packed streams, then route each bit position through the value-select MUX
  tree keyed by the parents' bits at that position.
* ``node_mux_gather_ref`` (threshold-gather): select the node's 8-bit DAC
  threshold by the parents' bits first, then compare one entropy byte.

They keep the reference's ``(cpt|cdf, rand_words, parents)`` contract:
entropy words are int64 in [0, 2**32), packed words int32 bit patterns.
Stream bit ``4 e + b`` (byte ``b`` of entropy word ``e`` of an output word)
lands at bit ``4 (e % 8) + b``.  The CUDA kernels in ``csrc/node_mux.cu``
compute the same words with the entropy hashed in registers.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitops, logic, rng


def _shifts(byte: int, device) -> torch.Tensor:
    """Bit positions ``4 e + byte`` of the 8 entropy words of one output word."""
    return torch.arange(8, dtype=torch.int64, device=device) * 4 + byte


def _lanes(rand: torch.Tensor, byte: int) -> torch.Tensor:
    """Byte ``byte`` of every entropy word, grouped (..., W, 8) by output word."""
    lane = (rand >> (8 * byte)) & 0xFF
    return lane.reshape(lane.shape[:-1] + (lane.shape[-1] // 8, 8))


def _pack(bits: torch.Tensor, byte: int) -> torch.Tensor:
    """(..., W, 8) 0/1 int64 bits of one byte lane -> (..., W) int64 words."""
    return (bits << _shifts(byte, bits.device)).sum(-1)


def node_mux_ref(cpt: torch.Tensor, rand: torch.Tensor, parents: torch.Tensor) -> torch.Tensor:
    """cpt (R, L) f32, rand (R, L, n_rand) int64, parents (m, R, W) int32 -> (R, W) int32.

    L = 2**m, W = n_rand // 8.  CPT row index: first parent = most
    significant bit.
    """
    leaves = rng.packed_from_bytes(rand, rng.threshold_from_p(cpt))     # (R, L, W)
    return logic.mux_select(parents, leaves)


def gather_thresholds(thresh: torch.Tensor, parents: torch.Tensor, byte: int) -> torch.Tensor:
    """Per-position threshold gather: thresh (R, L) int64, parents (m, R, W)
    -> (R, W, 8) int64, the selected threshold at every stream position
    ``4 e + byte`` of each output word.  First parent = most significant
    row-index bit, as in ``logic.mux_select``.
    """
    m = parents.shape[0]
    shifts = _shifts(byte, parents.device)
    level = thresh.to(torch.int64)[:, None, None, :]                    # (R, 1, 1, L)
    for j in range(m - 1, -1, -1):
        pbit = (bitops.as_u32(parents[j])[..., None] >> shifts) & 1      # (R, W, 8)
        level = torch.where(pbit[..., None] == 1, level[..., 1::2], level[..., 0::2])
    return level[..., 0]


def cat_gather_body(cdf: torch.Tensor, rand: torch.Tensor, parents: torch.Tensor,
                    cards: tuple) -> torch.Tensor:
    """Categorical threshold-gather.

    cdf     (R, L, k-1) non-increasing cumulative DAC thresholds per
            mixed-radix CPT row (first parent = most significant digit).
    rand    (R, n_rand) int64 -- one entropy byte per stream position.
    parents (P, R, W) int32 packed value bit-planes; parent ``j`` owns the
            plane block ``[sum_{i<j} vbits_i, ...)``, LSB first.  P may be 0.
    cards   ``(k, k_p0, .., k_pm-1)``.

    Returns (vbits, R, W) int32: the sampled value's packed bit-planes.  A
    parent digit ``>= k_j`` selects row digit 0; the sampled value is the
    count of levels the byte lies below.
    """
    k = int(cards[0])
    pcards = tuple(int(c) for c in cards[1:])
    r, n_rand = rand.shape
    w = n_rand // 8
    vb = bitops.value_bits(k)
    offsets, off = [], 0
    for c in pcards:
        offsets.append(off)
        off += bitops.value_bits(c)
    cdf = cdf.to(torch.int64)
    planes = [torch.zeros((r, w), dtype=torch.int64, device=rand.device) for _ in range(vb)]
    for byte in range(4):
        lane = _lanes(rand, byte)                                       # (R, W, 8)
        shifts = _shifts(byte, rand.device)
        level = cdf[:, None, None, :, :]                                # (R, 1, 1, L, k-1)
        for j in range(len(pcards) - 1, -1, -1):
            kj = pcards[j]
            dj = torch.zeros((r, w, 8), dtype=torch.int64, device=rand.device)
            for b in range(bitops.value_bits(kj)):
                pbit = (bitops.as_u32(parents[offsets[j] + b])[..., None] >> shifts) & 1
                dj = dj | (pbit << b)
            lv = level.reshape(level.shape[:-2] + (level.shape[-2] // kj, kj, k - 1))
            acc = lv[..., 0, :]
            for d in range(1, kj):
                acc = torch.where((dj == d)[..., None, None], lv[..., d, :], acc)
            level = acc
        level = level[..., 0, :]                                        # (R, W, 8, k-1)
        cnt = (lane[..., None] < level).sum(-1)
        for b in range(vb):
            planes[b] = planes[b] | _pack((cnt >> b) & 1, byte)
    return bitops.as_i32(torch.stack(planes))


def node_mux_cat_ref(cdf: torch.Tensor, rand: torch.Tensor, parents: torch.Tensor,
                     cards: tuple) -> torch.Tensor:
    """Plain version of the categorical gather (see :func:`cat_gather_body`)."""
    return cat_gather_body(cdf, rand, parents, cards)


def node_mux_gather_ref(cpt: torch.Tensor, rand: torch.Tensor,
                        parents: torch.Tensor) -> torch.Tensor:
    """cpt (R, L) f32, rand (R, n_rand) int64, parents (m, R, W) int32 -> (R, W) int32.

    Threshold-gather: one entropy byte per stream bit whatever the fan-in.
    """
    thresh = rng.threshold_from_p(cpt)                                  # (R, L)
    acc = None
    for byte in range(4):
        bits = (_lanes(rand, byte) < gather_thresholds(thresh, parents, byte)).to(torch.int64)
        word = _pack(bits, byte)
        acc = word if acc is None else acc | word
    return bitops.as_i32(acc)
