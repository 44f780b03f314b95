"""The analytic Bayesian fusion operator (paper Fig 4 / S10, eq (5)).

Fuses M conditionally-independent modal posteriors over K classes:

    p(y | x_1..x_M)  proportional-to  prod_i p(y | x_i) / p(y)^(M-1)      (eq 5)

``fuse_analytic`` is the float oracle (the eq-(5) math that ``fusion_map``
computes at video scale, Movie S1).  Both functions run on the device of the
tensor they are given.  The stochastic circuit (``bayes_fusion``,
``detection_fusion``) is still to be ported.
"""

from __future__ import annotations

import torch


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
