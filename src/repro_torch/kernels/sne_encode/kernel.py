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
BODY = SOURCE.parent / "sne_body.h"     # the per-word body, shared with bayes_decide
MAX_BLOCKS = 1 << 16                    # the grid-stride loop walks the rest
MAX_CHUNK = 8                           # words per thread of a tile (as in the .cu)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, with its C signature declared."""
    lib = backend.load_library(SOURCE)
    p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    lib.sne_encode_launch.argtypes = [p, p, ll, i, u, u, u, i, i, p]
    lib.sne_encode_launch.restype = i
    return lib


def sne_encode_cuda(kd0: int, kd1: int, p: torch.Tensor, *, n_bits: int,
                    offset: int = 0) -> torch.Tensor:
    """p (R,) float32 on a CUDA device -> (R, n_bits // 32) int32 packed words.

    ``chunk`` is the most words per thread, up to ``MAX_CHUNK``, that still
    fill the card.  At chunk 1 a thread takes a word in turn; above it a
    block takes tiles of the rows of 256 * chunk words, stores the words of
    rows at level 0 or 256 and hashes the rest, a thread per word.  At most
    ``MAX_BLOCKS`` blocks.

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
    chunk = backend.items_per_thread(p.shape[0] * n_out,
                                     backend.fill_threads(p.device.index or 0), MAX_CHUNK)
    lib = library()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.sne_encode_launch(
            p.data_ptr(), out.data_ptr(), p.shape[0], n_out, kd0 & MASK32,
            kd1 & MASK32, int(offset) & MASK32, chunk, MAX_BLOCKS, stream)
    if err != 0:
        raise RuntimeError(f"sne_encode kernel launch failed: cudaError {err}")
    sne_encode_cuda.launches += 1
    return out


sne_encode_cuda.launches = 0
