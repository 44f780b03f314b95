"""Plain torch version of the fused probabilistic-AND + popcount."""

from __future__ import annotations

import torch

from repro_torch.core import bitops


def pand_popcount_ref(streams: torch.Tensor) -> torch.Tensor:
    """AND-reduce streams over the leading modality axis, then popcount.

    streams: (M, R, n_words) packed words (int32 bit patterns, or int64 in
             [0, 2**32)).
    returns: (R,) int32 -- set bits of AND_m streams[m] per row (the
             Bayes-fusion numerator count, eq (5) before normalisation).
    """
    acc = streams[0]
    for i in range(1, streams.shape[0]):
        acc = acc & streams[i]
    return bitops.popcount(acc)
