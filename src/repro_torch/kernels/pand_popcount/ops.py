"""Public wrapper of the fused AND + popcount.

On the card the hand-written kernel (``kernel.pand_popcount_cuda``) launches
or raises; on the CPU the plain torch version (``ref.pand_popcount_ref``)
runs.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.pand_popcount.kernel import pand_popcount_cuda
from repro_torch.kernels.pand_popcount.ref import pand_popcount_ref


def as_words(streams) -> torch.Tensor:
    """Packed words as the port's int32 bit patterns (int32, or the reference's uint32)."""
    streams = torch.as_tensor(streams)
    if streams.dtype == torch.uint32:
        return streams.view(torch.int32)
    if streams.dtype != torch.int32:
        raise ValueError(f"packed words must be int32 or uint32, got {streams.dtype}")
    return streams


def pand_popcount(streams, *, device="cuda") -> torch.Tensor:
    """Fused probabilistic AND across modalities + popcount.

    streams: (M, ..., n_words) packed words.  Returns (...,) int32 counts on
    ``device``.
    """
    streams = as_words(streams).to(backend.resolve_device(device))
    if streams.dim() < 2:
        raise ValueError(f"streams must be (M, ..., n_words), got {tuple(streams.shape)}")
    m, n_words = streams.shape[0], streams.shape[-1]
    flat = streams.reshape(m, -1, n_words)
    if flat.device.type == "cuda":
        out = pand_popcount_cuda(flat)
    else:
        out = pand_popcount_ref(flat)
    return out.reshape(streams.shape[1:-1])
