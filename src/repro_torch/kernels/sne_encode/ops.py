"""Public wrapper of the stochastic number encoder.

The tensor's device decides what runs: on the card the hand-written kernel
(``kernel.sne_encode_cuda``) draws its entropy in registers and launches or
raises; on the CPU the plain torch version (``ref.sne_encode_ref``) runs on
words drawn by ``counter_hash_words``.  The two draw the same words.
"""

from __future__ import annotations

import torch

from repro_torch.core import rng
from repro_torch.kernels import backend
from repro_torch.kernels.sne_encode.kernel import sne_encode_cuda
from repro_torch.kernels.sne_encode.ref import sne_encode_ref


def sne_encode(key, p, n_bits: int = 128, *, device="cuda") -> torch.Tensor:
    """Encode probabilities ``p`` (any shape) into packed stochastic numbers.

    ``key``: ``(2,)`` uint32 key data (``repro_torch.core.prng``).  n_bits
    must be a multiple of 32.  Returns ``p.shape + (n_bits // 32,)`` int32
    words on ``device``.  Entry ``i`` of the flattened ``p`` draws the
    counters ``i * n_bits // 4 ..`` (mod 2**32).
    """
    if n_bits % 32 or n_bits <= 0:
        raise ValueError(f"n_bits must be a positive multiple of 32, got {n_bits}")
    p = torch.as_tensor(p, dtype=torch.float32).to(backend.resolve_device(device))
    flat = p.reshape(-1)
    if flat.device.type == "cuda":
        kd0, kd1 = rng.seed_words(key)
        out = sne_encode_cuda(kd0, kd1, flat, n_bits=n_bits)
    else:
        rand = rng.counter_hash_words(key, (flat.shape[0],), rng.n_rand_words(n_bits))
        out = sne_encode_ref(flat, rand)
    return out.reshape(p.shape + (n_bits // 32,))
