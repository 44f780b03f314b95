"""Public wrapper of the analytic fusion map.

On the card the hand-written kernel (``kernel.fusion_map_cuda``) launches or
raises; on the CPU the plain torch version (``ref.fusion_map_ref``) runs.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.fusion_map.kernel import fusion_map_cuda
from repro_torch.kernels.fusion_map.ref import fusion_map_ref


def _prepare(p_modal, prior, device):
    """(p on the device, its (M, R, K) view, the prior on the device or None)."""
    dev = backend.resolve_device(device)
    p_modal = torch.as_tensor(p_modal, dtype=torch.float32).to(dev)
    if p_modal.dim() < 2:
        raise ValueError(f"p_modal must be (M, ..., K), got {tuple(p_modal.shape)}")
    m, k = p_modal.shape[0], p_modal.shape[-1]
    if prior is not None:
        prior = torch.as_tensor(prior, dtype=torch.float32).to(dev).contiguous()
    return p_modal, p_modal.reshape(m, -1, k), prior


def _launch(flat, prior):
    if flat.device.type == "cuda":
        return fusion_map_cuda(flat.contiguous(), prior)
    if prior is None:
        prior = torch.full((flat.shape[-1],), 1.0 / flat.shape[-1], dtype=torch.float32)
    return fusion_map_ref(flat, prior)


def fusion_map(p_modal, prior=None, *, device="cuda", trace=None) -> torch.Tensor:
    """Analytic eq-(5) fusion over class maps.

    p_modal: (M, ..., K); prior (K,) or None (uniform).  Returns (..., K)
    float32 on ``device``.  On the card a call on a contiguous float32
    tensor there is one kernel launch: a uniform prior is the kernel's own.
    With a ``trace`` (:class:`~repro_torch.obs.Tracer`) the call records an
    ``op.fusion_map`` span with children ``op.prepare`` (conversion, reshape)
    and ``op.launch`` (the output, the launch).
    """
    if trace is None:
        p_modal, flat, prior = _prepare(p_modal, prior, device)
        return _launch(flat, prior).reshape(p_modal.shape[1:])
    with trace.span("op.fusion_map"):
        with trace.span("op.prepare"):
            p_modal, flat, prior = _prepare(p_modal, prior, device)
        with trace.span("op.launch"):
            out = _launch(flat, prior)
        return out.reshape(p_modal.shape[1:])
