"""Wrapper of the hand-written CUDA ``sne_encode`` kernel (``csrc/sne_encode.cu``).

Replaces the TPU kernel ``repro/kernels/sne_encode/kernel.py::sne_encode_pallas``.
The kernel hashes its entropy words in registers from the two seed words and
a counter origin, so the caller passes no entropy tensor.  It runs on the
current CUDA stream and does not synchronise; a refused launch raises here.
``sne_encode_cuda.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.core.bitops import MASK32
from repro_torch.kernels import backend

SOURCE = pathlib.Path(__file__).parent / "csrc" / "sne_encode.cu"
THREADS = 256


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, with its C signature declared."""
    lib = backend.load_library(SOURCE)
    p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    lib.sne_encode_launch.argtypes = [p, p, ll, i, u, u, u, i, p]
    lib.sne_encode_launch.restype = i
    return lib


def sne_encode_cuda(kd0: int, kd1: int, p: torch.Tensor, *, n_bits: int,
                    offset: int = 0) -> torch.Tensor:
    """p (R,) float32 on a CUDA device -> (R, n_bits // 32) int32 packed words.

    Entropy word ``i`` of row ``r`` hashes the counter ``r * n_bits // 4 + i
    + offset`` (mod 2**32), as ``counter_hash_words(key, (R,), n_bits // 4,
    offset=offset)`` does.
    """
    if p.device.type != "cuda":
        raise ValueError(f"sne_encode_cuda needs a CUDA tensor, got {p.device}")
    if p.dtype != torch.float32 or p.dim() != 1:
        raise ValueError(f"p must be (R,) float32, got {tuple(p.shape)} {p.dtype}")
    if n_bits % 32 or n_bits <= 0:
        raise ValueError(f"n_bits must be a positive multiple of 32, got {n_bits}")
    p = p.contiguous()
    n_out = n_bits // 32
    out = torch.empty((p.shape[0], n_out), dtype=torch.int32, device=p.device)
    if p.shape[0] == 0:
        return out
    lib = library()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.sne_encode_launch(
            p.data_ptr(), out.data_ptr(), p.shape[0], n_out, kd0 & MASK32,
            kd1 & MASK32, int(offset) & MASK32, THREADS, stream)
    if err != 0:
        raise RuntimeError(f"sne_encode kernel launch failed: cudaError {err}")
    sne_encode_cuda.launches += 1
    return out


sne_encode_cuda.launches = 0
