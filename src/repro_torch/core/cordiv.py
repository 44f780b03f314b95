"""CORDIV fixed point from popcounts (the count-level half of eq (5))."""

from __future__ import annotations

import torch


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
