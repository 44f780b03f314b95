"""Bayes decision head: the paper's operators at the LM decision layer.

Fuses K-way token posteriors from several conditionally-independent sources
(MTP head vs main head, modality branches, ensemble samples) with eq (5), and
gates emission on the fused confidence -- the LM analogue of the paper's
timely-reliable lane-change decision.

Two paths:
* analytic   -- float eq (5) over the top-k candidate tokens.
* stochastic -- the paper's circuit through one fused ``bayes_decide`` launch.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.fusion import fuse_analytic
from repro_torch.kernels import backend
from repro_torch.kernels.bayes_decide.ops import bayes_decide


def _candidates(logits_sources, top_k: int, device):
    """(M, B, V) logits -> (candidate ids (B, k), per-source softmax over them (M, B, k)).

    Candidates are the top-k of the mean logits in ``lax.top_k``'s order."""
    x = torch.as_tensor(logits_sources, dtype=torch.float32).to(backend.resolve_device(device))
    m = x.shape[0]
    # lax.top_k's order: by value, equal values by index (a stable sort);
    # bf16 logits tie often, and torch.topk orders ties as it likes
    cand = torch.sort(x.mean(0), dim=-1, descending=True, stable=True)[1][..., :top_k]
    cand_logits = torch.gather(x, -1, cand[None].expand(m, -1, -1))
    return cand, torch.softmax(cand_logits, dim=-1)


def _pick(cand, fused, best):
    token = torch.gather(cand, -1, best[:, None].to(torch.int64))[:, 0]
    conf = torch.gather(fused, -1, best[:, None].to(torch.int64))[:, 0]
    return token, conf


def fuse_posteriors(
    logits_sources, top_k: int = 8, *, device="cuda"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fuse per-source next-token posteriors over the union top-k candidates.

    logits_sources: (M, B, V).  Returns (token (B,), confidence (B,),
    fused_topk (B, top_k)).  Candidates are the top-k of the mean logits; each
    source's posterior is restricted and renormalised over the candidates,
    then fused with eq (5) under a uniform candidate prior.
    """
    cand, p = _candidates(logits_sources, top_k, device)
    fused = fuse_analytic(p.movedim(0, -2))                        # (B, k)
    token, conf = _pick(cand, fused, torch.argmax(fused, dim=-1))
    return token, conf, fused


def reliable_decision(
    token: torch.Tensor, conf: torch.Tensor, threshold: float = 0.7
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Timely-reliable gating: emit only when the fused confidence clears threshold.

    Returns (accept (B,) bool, token).  Rejected positions fall back to the
    caller's policy (resample, defer to a bigger model, keep lane -- the
    paper's P(A|B) < P(A) branch).
    """
    return conf >= threshold, token


def fuse_posteriors_stochastic(
    key, logits_sources, top_k: int = 8, n_bits: int = 256, *, device="cuda"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same decision through the paper's SC circuit, via the fused kernel.

    One ``bayes_decide`` launch does encode -> M-way AND -> popcount ->
    argmax in a single pass; nothing per-bit is stored.
    """
    cand, p = _candidates(logits_sources, top_k, device)
    best, counts = bayes_decide(key, p, n_bits, device=p.device)  # (B,), (B, k)
    fused = counts.to(torch.float32) / torch.clamp(
        counts.sum(-1, keepdim=True).to(torch.float32), min=1.0)
    return _pick(cand, fused, best)
