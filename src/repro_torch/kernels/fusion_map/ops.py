"""Public wrapper of the analytic fusion map.

On the card the hand-written kernel (``kernel.fusion_map_cuda``) launches or
raises; on the CPU the plain torch version (``ref.fusion_map_ref``) runs.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.fusion_map.kernel import fusion_map_cuda
from repro_torch.kernels.fusion_map.ref import fusion_map_ref


def fusion_map(p_modal, prior=None, *, device="cuda") -> torch.Tensor:
    """Analytic eq-(5) fusion over class maps.

    p_modal: (M, ..., K); prior (K,) or None (uniform).  Returns (..., K)
    float32 on ``device``.  On the card a call on a contiguous float32
    tensor there is one kernel launch: a uniform prior is the kernel's own.
    """
    dev = backend.resolve_device(device)
    p_modal = torch.as_tensor(p_modal, dtype=torch.float32).to(dev)
    if p_modal.dim() < 2:
        raise ValueError(f"p_modal must be (M, ..., K), got {tuple(p_modal.shape)}")
    m, k = p_modal.shape[0], p_modal.shape[-1]
    if prior is not None:
        prior = torch.as_tensor(prior, dtype=torch.float32).to(dev).contiguous()
    flat = p_modal.reshape(m, -1, k)
    if flat.device.type == "cuda":
        out = fusion_map_cuda(flat.contiguous(), prior)
    else:
        if prior is None:
            prior = torch.full((k,), 1.0 / k, dtype=torch.float32)
        out = fusion_map_ref(flat, prior)
    return out.reshape(p_modal.shape[1:])
