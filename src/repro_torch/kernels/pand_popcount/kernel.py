"""Wrapper of the hand-written CUDA ``pand_popcount`` kernel (``csrc/pand_popcount.cu``).

Replaces the TPU kernel ``repro/kernels/pand_popcount/kernel.py::pand_popcount_pallas``.
It runs on the current CUDA stream and does not synchronise; a refused
launch raises here.  ``pand_popcount_cuda.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import backend

SOURCE = pathlib.Path(__file__).parent / "csrc" / "pand_popcount.cu"
THREADS = 256


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, with its C signature declared."""
    lib = backend.load_library(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pand_popcount_launch.argtypes = [p, p, i, ll, i, i, p]
    lib.pand_popcount_launch.restype = i
    return lib


def pand_popcount_cuda(streams: torch.Tensor) -> torch.Tensor:
    """streams (M, R, W) int32 words on a CUDA device -> (R,) int32 counts."""
    if streams.device.type != "cuda":
        raise ValueError(f"pand_popcount_cuda needs a CUDA tensor, got {streams.device}")
    if streams.dtype != torch.int32 or streams.dim() != 3 or streams.shape[0] < 1:
        raise ValueError(f"streams must be (M, R, W) int32 with M >= 1, got "
                         f"{tuple(streams.shape)} {streams.dtype}")
    streams = streams.contiguous()
    m, r, w = streams.shape
    out = torch.zeros((r,), dtype=torch.int32, device=streams.device)
    if r == 0 or w == 0:
        return out
    lib = library()
    with torch.cuda.device(streams.device):
        stream = torch.cuda.current_stream(streams.device).cuda_stream
        err = lib.pand_popcount_launch(streams.data_ptr(), out.data_ptr(), m, r, w,
                                       THREADS, stream)
    if err != 0:
        raise RuntimeError(f"pand_popcount kernel launch failed: cudaError {err}")
    pand_popcount_cuda.launches += 1
    return out


pand_popcount_cuda.launches = 0
