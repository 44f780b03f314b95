"""Wrapper of the hand-written CUDA ``fusion_map`` kernel (``csrc/fusion_map.cu``).

Replaces the TPU kernel ``repro/kernels/fusion_map/kernel.py::fusion_map_pallas``.
The kernel computes the pre-scaled log prior itself, from the prior or, for
``prior=None``, from the uniform value ``float32(1 / K)``: a call is one
launch, and the wrapper's only torch op is the output's ``torch.empty``.  The
kernel runs on the current CUDA stream and does not synchronise; a refused
launch raises here.  ``fusion_map_cuda.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

import numpy as np
import torch

from repro_torch.kernels import backend

SOURCE = pathlib.Path(__file__).parent / "csrc" / "fusion_map.cu"
ROUTES = {1: "group", 2: "pair", 0: "tile"}   # fusion_map_route's codes


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, with its C signatures declared."""
    lib = backend.load_library(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fusion_map_launch.argtypes = [p, p, ctypes.c_float, p, i, ll, i, p]
    lib.fusion_map_launch.restype = i
    lib.fusion_map_route.argtypes = [p, p, ll, i]
    lib.fusion_map_route.restype = i
    return lib


def route(p_modal: torch.Tensor, out: torch.Tensor) -> str:
    """The kernel a call on ``p_modal`` (M, R, K) writing ``out`` takes:
    ``"group"`` (K a multiple of 4 up to 128: lanes per row, no shared
    memory), ``"pair"`` (K = 2: whole rows per lane) or ``"tile"`` (any
    other K or alignment: rows tiled in shared memory)."""
    _, r, k = p_modal.shape
    return ROUTES[library().fusion_map_route(p_modal.data_ptr(), out.data_ptr(), r, k)]


def fusion_map_cuda(p_modal: torch.Tensor, prior: torch.Tensor | None = None) -> torch.Tensor:
    """p_modal (M, R, K) contiguous float32 on a CUDA device, prior (K,)
    float32 on the same device or ``None`` (uniform) -> (R, K) float32."""
    if p_modal.device.type != "cuda":
        raise ValueError(f"fusion_map_cuda needs a CUDA tensor, got {p_modal.device}")
    if p_modal.dtype != torch.float32 or p_modal.dim() != 3 or p_modal.shape[0] < 1 \
            or not p_modal.is_contiguous():
        raise ValueError(f"p_modal must be contiguous (M, R, K) float32 with M >= 1, got "
                         f"{tuple(p_modal.shape)} {p_modal.dtype}")
    m, r, k = p_modal.shape
    if prior is not None and (prior.dtype != torch.float32 or tuple(prior.shape) != (k,)
                              or prior.device != p_modal.device or not prior.is_contiguous()):
        raise ValueError(f"prior must be ({k},) float32 on {p_modal.device}, got "
                         f"{tuple(prior.shape)} {prior.dtype} on {prior.device}")
    out = torch.empty((r, k), dtype=torch.float32, device=p_modal.device)
    if r == 0 or k == 0:
        return out
    lib = library()
    # torch.full((k,), 1.0 / k, dtype=float32)'s value: the double rounded once
    uniform = float(np.float32(1.0 / k))
    with torch.cuda.device(p_modal.device):
        stream = torch.cuda.current_stream(p_modal.device).cuda_stream
        err = lib.fusion_map_launch(p_modal.data_ptr(), None if prior is None else prior.data_ptr(),
                                    uniform, out.data_ptr(), m, r, k, stream)
    if err != 0:
        raise RuntimeError(f"fusion_map kernel launch failed: cudaError {err}")
    fusion_map_cuda.launches += 1
    return out


fusion_map_cuda.launches = 0
