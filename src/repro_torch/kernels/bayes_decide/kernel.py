"""Wrapper of the hand-written CUDA ``bayes_decide`` kernel (``csrc/bayes_decide.cu``).

Replaces the TPU kernel ``repro/kernels/bayes_decide/kernel.py::bayes_decide_pallas``.
The kernel hashes its entropy words in registers from the two seed words and
a counter origin, so the caller passes no entropy tensor.  It runs on the
current CUDA stream and does not synchronise; a refused launch raises here.
``bayes_decide_cuda.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.core.bitops import MASK32
from repro_torch.kernels import backend

SOURCE = pathlib.Path(__file__).parent / "csrc" / "bayes_decide.cu"
THREADS = 128     # rows per block: small batches still spread over the SMs


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, with its C signature declared."""
    lib = backend.load_library(SOURCE)
    p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    lib.bayes_decide_launch.argtypes = [p, p, p, i, ll, i, i, u, u, u, i, p]
    lib.bayes_decide_launch.restype = i
    return lib


def bayes_decide_cuda(kd0: int, kd1: int, p: torch.Tensor, *, n_bits: int,
                      offset: int = 0):
    """p (M, R, K) float32 on a CUDA device -> (decisions (R,), counts (R, K)) int32.

    Entropy word ``i`` of stream ``(m, r, k)`` hashes the counter
    ``((m * R + r) * K + k) * n_bits // 4 + i + offset`` (mod 2**32), as
    ``counter_hash_words(key, (M, R, K), n_bits // 4, offset=offset)`` does.
    """
    if p.device.type != "cuda":
        raise ValueError(f"bayes_decide_cuda needs a CUDA tensor, got {p.device}")
    if p.dtype != torch.float32 or p.dim() != 3 or p.shape[0] < 1:
        raise ValueError(f"p must be (M, R, K) float32 with M >= 1, got "
                         f"{tuple(p.shape)} {p.dtype}")
    if n_bits % 32 or n_bits <= 0:
        raise ValueError(f"n_bits must be a positive multiple of 32, got {n_bits}")
    p = p.contiguous()
    m, r, k = p.shape
    dec = torch.zeros((r,), dtype=torch.int32, device=p.device)
    counts = torch.zeros((r, k), dtype=torch.int32, device=p.device)
    if r == 0 or k == 0:
        return dec, counts
    lib = library()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.bayes_decide_launch(
            p.data_ptr(), dec.data_ptr(), counts.data_ptr(), m, r, k, n_bits // 32,
            kd0 & MASK32, kd1 & MASK32, int(offset) & MASK32, THREADS, stream)
    if err != 0:
        raise RuntimeError(f"bayes_decide kernel launch failed: cudaError {err}")
    bayes_decide_cuda.launches += 1
    return dec, counts


bayes_decide_cuda.launches = 0
