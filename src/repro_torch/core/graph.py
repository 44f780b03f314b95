"""Bayesian-network dependency structures from Fig S8.

* one-parent-one-child  (A -> B)          : 2x1 MUX  -- :mod:`repro_torch.core.inference`
* two-parent-one-child  (A1 -> B <- A2)   : 4x1 MUX
* one-parent-two-child  (B1 <- A -> B2)   : two 2x1 MUXes

Every operator keeps the numerator a bitwise subset of the denominator by
sharing the parent and likelihood SNE streams, as in the paper.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import bitops, cordiv, logic, prng, sne
from repro_torch.core.device import _f32
from repro_torch.core.inference import _posterior
from repro_torch.kernels.backend import resolve_device


def analytic_two_parent(p_a1, p_a2, cpt, *, device="cuda") -> torch.Tensor:
    """P(A1=1 | B=1) with cpt[i, j] = P(B=1 | A1=i, A2=j)."""
    dev = resolve_device(device)
    p_a1, p_a2, cpt = _f32(p_a1, dev), _f32(p_a2, dev), _f32(cpt, dev)
    w = torch.stack([
        (1 - p_a1) * (1 - p_a2) * cpt[0, 0],
        (1 - p_a1) * p_a2 * cpt[0, 1],
        p_a1 * (1 - p_a2) * cpt[1, 0],
        p_a1 * p_a2 * cpt[1, 1],
    ])
    p_b = ((w[0] + w[1]) + w[2]) + w[3]        # the reference's sum over 4, in order
    return _posterior(w[2] + w[3], p_b)


def two_parent_one_child(key, p_a1, p_a2, cpt, n_bits: int = 100, *,
                         device="cuda") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Posterior P(A1|B=1) via a 4x1 MUX (Fig S8b).

    Returns (posterior_scan, posterior_ratio, analytic).
    """
    dev = resolve_device(device)
    cpt = _f32(cpt, dev)
    k1, k2, kc = prng.split(key, 3)
    s_a1 = sne.encode_uncorrelated(k1, p_a1, n_bits, device=dev)
    s_a2 = sne.encode_uncorrelated(k2, p_a2, n_bits, device=dev)
    kcs = prng.split(kc, 4)
    s_cpt = [sne.encode_uncorrelated(kcs[2 * i + j], cpt[i, j], n_bits, device=dev)
             for i in range(2) for j in range(2)]       # order: 00, 01, 10, 11
    # 4x1 MUX: selects are (A1, A2), A1 the high bit -- the shared n-ary tree
    leaves = torch.stack(s_cpt, dim=-2)
    denom = logic.mux_select(torch.stack([s_a1, s_a2]), leaves)        # = P(B)
    hi = logic.mux_select(s_a2[None], leaves[..., 2:, :])              # A1 = 1 branch
    numer = bitops.band(s_a1, hi)                                      # = P(A1=1, B)
    _, post_scan = cordiv.cordiv_fill(numer, denom, n_bits)
    post_ratio = cordiv.cordiv_ratio(numer, denom)
    return post_scan, post_ratio, analytic_two_parent(p_a1, p_a2, cpt, device=dev)


def analytic_one_parent_two_child(p_a, p_b1, p_b2, *, device="cuda") -> torch.Tensor:
    """P(A=1 | B1=1, B2=1); p_bi = (P(Bi|A), P(Bi|notA))."""
    dev = resolve_device(device)
    p_a, p_b1, p_b2 = _f32(p_a, dev), _f32(p_b1, dev), _f32(p_b2, dev)
    num = p_a * p_b1[0] * p_b2[0]
    den = num + (1 - p_a) * p_b1[1] * p_b2[1]
    return _posterior(num, den)


def one_parent_two_child(key, p_a, p_b1, p_b2, n_bits: int = 100, *,
                         device="cuda") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Posterior P(A | B1, B2) via two 2x1 MUXes (Fig S8c).

    ``p_b1``/``p_b2`` are pairs (P(Bi|A), P(Bi|notA)).
    Returns (posterior_scan, posterior_ratio, analytic).
    """
    dev = resolve_device(device)
    ka, k1a, k1n, k2a, k2n = prng.split(key, 5)
    s_a = sne.encode_uncorrelated(ka, p_a, n_bits, device=dev)
    s_b1a = sne.encode_uncorrelated(k1a, p_b1[0], n_bits, device=dev)
    s_b1n = sne.encode_uncorrelated(k1n, p_b1[1], n_bits, device=dev)
    s_b2a = sne.encode_uncorrelated(k2a, p_b2[0], n_bits, device=dev)
    s_b2n = sne.encode_uncorrelated(k2n, p_b2[1], n_bits, device=dev)
    numer = s_a & s_b1a & s_b2a
    denom = bitops.band(bitops.bmux(s_a, s_b1n, s_b1a), bitops.bmux(s_a, s_b2n, s_b2a))
    _, post_scan = cordiv.cordiv_fill(numer, denom, n_bits)
    post_ratio = cordiv.cordiv_ratio(numer, denom)
    return post_scan, post_ratio, analytic_one_parent_two_child(p_a, p_b1, p_b2, device=dev)
