"""Wrapper of the hand-written CUDA ``fusion_map`` kernel (``csrc/fusion_map.cu``).

Replaces the TPU kernel ``repro/kernels/fusion_map/kernel.py::fusion_map_pallas``.
Like that wrapper, this one computes the pre-scaled log prior and hands it to
the kernel.  The kernel runs on the current CUDA stream and does not
synchronise; a refused launch raises here.  ``fusion_map_cuda.launches``
counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.fusion_map.ref import log_prior

SOURCE = pathlib.Path(__file__).parent / "csrc" / "fusion_map.cu"
THREADS = 128
TILE_ELEMENTS = 2048      # log-scores a block keeps in shared memory (8 KB)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, with its C signature declared."""
    lib = backend.load_library(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fusion_map_launch.argtypes = [p, p, p, i, ll, i, i, i, p]
    lib.fusion_map_launch.restype = i
    return lib


def fusion_map_cuda(p_modal: torch.Tensor, prior: torch.Tensor) -> torch.Tensor:
    """p_modal (M, R, K), prior (K,) float32 on a CUDA device -> (R, K) float32."""
    if p_modal.device.type != "cuda":
        raise ValueError(f"fusion_map_cuda needs a CUDA tensor, got {p_modal.device}")
    if p_modal.dtype != torch.float32 or p_modal.dim() != 3 or p_modal.shape[0] < 1:
        raise ValueError(f"p_modal must be (M, R, K) float32 with M >= 1, got "
                         f"{tuple(p_modal.shape)} {p_modal.dtype}")
    m, r, k = p_modal.shape
    if prior.dtype != torch.float32 or tuple(prior.shape) != (k,) \
            or prior.device != p_modal.device:
        raise ValueError(f"prior must be ({k},) float32 on {p_modal.device}, got "
                         f"{tuple(prior.shape)} {prior.dtype} on {prior.device}")
    p_modal = p_modal.contiguous()
    logprior = log_prior(prior, m).contiguous()
    out = torch.empty((r, k), dtype=torch.float32, device=p_modal.device)
    if r == 0 or k == 0:
        return out
    lib = library()
    with torch.cuda.device(p_modal.device):
        stream = torch.cuda.current_stream(p_modal.device).cuda_stream
        err = lib.fusion_map_launch(p_modal.data_ptr(), logprior.data_ptr(),
                                    out.data_ptr(), m, r, k, max(1, TILE_ELEMENTS // k),
                                    THREADS, stream)
    if err != 0:
        raise RuntimeError(f"fusion_map kernel launch failed: cudaError {err}")
    fusion_map_cuda.launches += 1
    return out


fusion_map_cuda.launches = 0
