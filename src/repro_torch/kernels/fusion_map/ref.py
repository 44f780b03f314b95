"""Plain torch version of the analytic Bayesian fusion map (eq (5))."""

from __future__ import annotations

import torch


def log_prior(prior: torch.Tensor, m: int) -> torch.Tensor:
    """(M - 1) * log clip(prior, 1e-9, 1): the prior term of eq (5), pre-scaled."""
    return (m - 1) * torch.log(torch.clamp(prior, 1e-9, 1.0))


def fusion_map_ref(p_modal: torch.Tensor, prior: torch.Tensor) -> torch.Tensor:
    """Normalised multimodal fusion over per-pixel class posteriors.

    p_modal: (M, R, K) float32 -- per-modality class posteriors for R pixels.
    prior:   (K,) float32 class prior.
    returns: (R, K) float32, rows sum to 1:
             softmax_k( sum_m log p_mk - (M-1) log prior_k ).
    """
    logq = torch.log(torch.clamp(p_modal, 1e-9, 1.0)).sum(0) - log_prior(prior, p_modal.shape[0])
    logq = logq - logq.max(dim=-1, keepdim=True).values
    q = torch.exp(logq)
    return q / q.sum(dim=-1, keepdim=True)
