"""Hardware Bayesian fusion operator (paper Fig 4 / S9 / S10, eqs (2)-(5)).

Fuses M conditionally-independent modal posteriors over K classes:

    p(y | x_1..x_M)  proportional-to  prod_i p(y | x_i) / p(y)^(M-1)      (eq 5)

Circuit: one probabilistic AND chain per class (the numerator products),
division by the prior via CORDIV, and the Fig-S10 normalisation module so the
class scores sum to one: its denominator is a MUX tree (weighted adder) over
the class-numerator streams with fresh selects, its ratio CORDIV; the
serial-circuit and the closed-form popcount paths are both given
(:func:`bayes_fusion`).

``fuse_analytic`` is the float oracle (the eq-(5) math that ``fusion_map``
computes at video scale, Movie S1); it runs on the device of the tensor it is
given.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core import bitops, cordiv, logic, prng, sne
from repro_torch.kernels.backend import resolve_device


def _prior(prior, k: int, device) -> torch.Tensor:
    """The (K,) float32 class prior on ``device``; uniform when None."""
    if prior is None:
        return torch.full((k,), 1.0 / k, dtype=torch.float32, device=device)
    return torch.as_tensor(prior, dtype=torch.float32, device=device)


def fuse_analytic(p_modal, prior=None) -> torch.Tensor:
    """Eq (5) with normalisation.

    p_modal: (..., M, K) single-modal posteriors over K classes.
    prior:   (K,) class prior; uniform if None (the paper's circuit assumption).
    Returns (..., K) normalised fused posterior.
    """
    p_modal = torch.as_tensor(p_modal, dtype=torch.float32)
    m, k = p_modal.shape[-2], p_modal.shape[-1]
    prior = _prior(prior, k, p_modal.device)
    log_q = torch.log(torch.clamp(p_modal, 1e-9, 1.0)).sum(-2) - (
        m - 1) * torch.log(torch.clamp(prior, 1e-9, 1.0))
    q = torch.exp(log_q - log_q.max(dim=-1, keepdim=True).values)
    return q / q.sum(dim=-1, keepdim=True)


def fuse_unnormalized_analytic(p_modal, prior=None) -> torch.Tensor:
    """Eq (5) numerator  prod_i p_i / prior^(M-1)  (may exceed 1 -- Fig S10 rationale)."""
    p_modal = torch.as_tensor(p_modal, dtype=torch.float32)
    m, k = p_modal.shape[-2], p_modal.shape[-1]
    prior = _prior(prior, k, p_modal.device)
    return torch.prod(p_modal, dim=-2) / prior ** (m - 1)


@dataclasses.dataclass
class FusionTrace:
    streams: Dict[str, torch.Tensor]
    n_bits: int
    fused_scan: torch.Tensor      # (..., K) serial-circuit normalised posterior
    fused_ratio: torch.Tensor     # (..., K) closed-form normalised posterior
    fused_analytic: torch.Tensor  # (..., K) float oracle


def _sum_classes(x: torch.Tensor) -> torch.Tensor:
    """Sum over the trailing class axis, left to right (the same rounding on
    every device), keeping the axis."""
    acc = x[..., 0]
    for c in range(1, x.shape[-1]):
        acc = acc + x[..., c]
    return acc[..., None]


def bayes_fusion(key, p_modal, n_bits: int = 100, prior=None, impl: str = "fast", *,
                 device="cuda") -> FusionTrace:
    """Run the hardware Bayesian fusion operator on ``device``.

    p_modal: (..., M, K).  The M modal streams per class come from parallel
    SNEs (conditional independence, eq (3)); the normalisation MUX tree uses
    fresh selects (Fig S6 requirement).  ``impl='threefry'`` draws every
    stream -- encoders and MUX-tree selects alike -- from the Threefry cipher.
    """
    dev = resolve_device(device)
    p_modal = torch.as_tensor(p_modal, dtype=torch.float32, device=dev)
    m, k = p_modal.shape[-2], p_modal.shape[-1]
    k_enc, k_tree = prng.split(key)
    # (..., M, K, n_words) independent streams -- one SNE per (modality, class)
    s_modal = sne.encode_uncorrelated(k_enc, p_modal, n_bits, impl=impl, device=dev)
    # numerator per class: AND across modalities (one-step multiplication)
    numer = s_modal[..., 0, :, :]
    for i in range(1, m):
        numer = bitops.band(numer, s_modal[..., i, :, :])          # (..., K, n_words)
    # normalisation denominator: MUX tree over class numerators -> (1/Kp) sum_j q_j
    denom, _ = logic.mux_tree(k_tree, numer, n_bits, impl=impl)  # (..., n_words)
    uniform = torch.full((), 1.0 / k, dtype=torch.float32, device=dev)

    # closed form: q_c / sum_j q_j (the 1/Kp scale cancels in the ratio)
    cnt_num = bitops.popcount(numer).to(torch.float32)           # (..., K)
    cnt_den = cnt_num.sum(dim=-1, keepdim=True)                  # integers: exact
    fused_ratio = torch.where(cnt_den > 0, cnt_num / torch.clamp(cnt_den, min=1.0), uniform)

    # serial circuit: CORDIV(numer_c, tree) with superset completion per class
    # (the tree output is not a bitwise superset; Fig S10's normalisation
    # module completes it with its feedback register)
    denom_sup = numer | denom[..., None, :]
    _, q_scan = cordiv.cordiv_fill(numer, denom_sup, n_bits)     # (..., K)
    z = _sum_classes(q_scan)
    fused_scan = torch.where(z > 0, q_scan / torch.clamp(z, min=1e-9), uniform)

    # a non-uniform prior enters the analytic oracle only: the circuit assumes
    # a uniform p(y) "for the convenience of circuit designs" (paper Methods)
    return FusionTrace(
        streams={"numer": numer, "denom": denom},
        n_bits=n_bits,
        fused_scan=fused_scan,
        fused_ratio=fused_ratio,
        fused_analytic=fuse_analytic(p_modal, prior),
    )


def detection_fusion(key, p_det_modal, n_bits: int = 100, *, device="cuda") -> torch.Tensor:
    """Binary obstacle-detection fusion (the Fig 4 use case).

    p_det_modal: (..., M) per-modality detection confidences of one candidate
    box; classes {obstacle, background}, uniform prior.  Returns the fused
    P(obstacle).
    """
    dev = resolve_device(device)
    p = torch.as_tensor(p_det_modal, dtype=torch.float32, device=dev)
    p2 = torch.stack([p, 1.0 - p], dim=-1)                        # (..., M, 2)
    return bayes_fusion(key, p2, n_bits=n_bits, device=dev).fused_ratio[..., 0]
