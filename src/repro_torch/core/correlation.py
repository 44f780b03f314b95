"""Stochastic-number correlation metrics (paper Methods: Pearson rho and SCC).

Both come from the 2x2 contingency counts of paired bits: a = #(1,1),
b = #(1,0), c = #(0,1), d = #(0,0).  The counts are exact integers; the
metrics are float32 with the reference's order of operations, on the
streams' device.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitops


def pair_counts(x: torch.Tensor, y: torch.Tensor, n_bits: int):
    """Contingency counts (a, b, c, d) of two packed streams (int32)."""
    mask = bitops.pad_mask(n_bits, device=x.device)
    nx = ~x & mask          # the reference's x ^ 0xFFFFFFFF on the valid bits
    ny = ~y & mask
    return (bitops.popcount(x & y), bitops.popcount(x & ny),
            bitops.popcount(nx & y), bitops.popcount(nx & ny))


def _float_counts(x, y, n_bits):
    return tuple(v.to(torch.float32) for v in pair_counts(x, y, n_bits))


def pearson(x: torch.Tensor, y: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Pearson correlation rho(S_x, S_y) from the paper's Methods formula."""
    a, b, c, d = _float_counts(x, y, n_bits)
    num = a * d - b * c
    den = torch.sqrt((a + b) * (a + c) * (b + d) * (c + d))
    return torch.where(den > 0, num / den, torch.zeros_like(num))


def scc(x: torch.Tensor, y: torch.Tensor, n_bits: int) -> torch.Tensor:
    """SC correlation (Alaghi & Hayes 2013) from the paper's Methods formula."""
    a, b, c, d = _float_counts(x, y, n_bits)
    zero = torch.zeros_like(a)
    n = a + b + c + d
    ad_bc = a * d - b * c
    den_pos = n * torch.minimum(a + b, a + c) - (a + b) * (a + c)
    den_neg = (a + b) * (a + c) - n * torch.clamp(a - d, min=0.0)
    return torch.where(
        ad_bc >= 0,
        torch.where(den_pos != 0, ad_bc / den_pos, zero),
        torch.where(den_neg != 0, ad_bc / den_neg, zero),
    )


def correlation_matrix(streams, n_bits: int, metric: str = "pearson") -> torch.Tensor:
    """Pairwise correlation matrix over a dict or list of packed streams."""
    fn = pearson if metric == "pearson" else scc
    items = list(streams.values()) if isinstance(streams, dict) else list(streams)
    return torch.stack([torch.stack([fn(u, v, n_bits) for v in items]) for u in items])
