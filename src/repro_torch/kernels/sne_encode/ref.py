"""Plain torch version of the stochastic number encoder (SNE).

Semantics (shared with the CUDA kernel, bit for bit): probabilities are
quantised to 8 bits (the V_in programming DAC of the hardware SNE), each
32-bit entropy word gives its 4 bytes as 4 uniform draws in 0..255, and a
stream bit is 1 iff ``byte < round(p * 256)``.  The output is packed
LSB-first, 32 stream bits per word; ``n_bits = 4 * n_rand = 32 * n_out``.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitops
from repro_torch.core.rng import threshold_from_p


def sne_encode_ref(p: torch.Tensor, rand_words: torch.Tensor) -> torch.Tensor:
    """Encode probabilities into packed stochastic numbers.

    p:          (..., R) float32 target probabilities.
    rand_words: (..., R, n_rand) int64 entropy words in [0, 2**32);
                n_rand must be a multiple of 8.
    returns:    (..., R, n_rand // 8) int32 packed words (natural bit order
                of the 4 * n_rand stream bits, byte ``b`` of word ``i`` at
                stream bit ``4 * i + b``).
    """
    n_rand = rand_words.shape[-1]
    if n_rand % 8:
        raise ValueError(f"n_rand must be a multiple of 8, got {n_rand}")
    thresh = threshold_from_p(p)[..., None, None]                        # (..., R, 1, 1)
    shifts = torch.arange(4, dtype=torch.int64, device=rand_words.device) * 8
    bytes_ = (rand_words[..., None] >> shifts) & 0xFF               # (..., R, n_rand, 4)
    bits = (bytes_ < thresh).to(torch.int64)
    grouped = bits.reshape(bits.shape[:-2] + (n_rand // 8, 32))
    pack_shifts = torch.arange(32, dtype=torch.int64, device=rand_words.device)
    return bitops.as_i32((grouped << pack_shifts).sum(-1))
