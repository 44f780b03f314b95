"""Plain torch version of the fused Bayes decision.

Semantics (shared with the CUDA kernel, bit for bit): each 32-bit entropy
word gives 4 uniform bytes; stream bit = ``byte < round(p * 256)``; a
decision's class score is the popcount of the M-way AND of its modal streams;
the decision is the first-occurrence argmax over classes.
"""

from __future__ import annotations

import torch

from repro_torch.core.rng import threshold_from_p


def bayes_decide_ref(p: torch.Tensor, rand_words: torch.Tensor):
    """p: (M, R, K) float32; rand_words: (M, R, K, n_rand) int64 in [0, 2**32).

    Returns (decisions (R,) int32, counts (R, K) int32).
    """
    thresh = threshold_from_p(p)[..., None]
    total = torch.zeros(p.shape[1:], dtype=torch.int32, device=p.device)
    for byte in range(4):
        lane = (rand_words >> (8 * byte)) & 0xFF
        joint = torch.all(lane < thresh, dim=0)                   # (R, K, n_rand)
        total = total + joint.sum(-1, dtype=torch.int32)
    # torch.argmax returns the first maximum: ties go to the lowest class
    return torch.argmax(total, dim=-1).to(torch.int32), total

