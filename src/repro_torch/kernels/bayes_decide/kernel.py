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
from repro_torch.kernels.sne_encode import kernel as sne_kernel

SOURCE = pathlib.Path(__file__).parent / "csrc" / "bayes_decide.cu"
DEPS = (sne_kernel.BODY,)     # the per-word body it includes from sne_encode
THREADS = 128                 # threads per block: one tile of rows
MAX_BLOCKS = 1 << 16          # the tile loop strides over the rest
MAX_SPLIT = 32                # threads of one stream: adjacent lanes of one warp
MAX_CHUNK = 8                 # streams a thread classifies per pass (THREADS * 8 = the queue)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, with its C signature declared."""
    lib = backend.load_library(SOURCE, deps=DEPS)
    p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    lib.bayes_decide_launch.argtypes = [p, p, p, i, ll, i, i, u, u, u, i, i, i, i, i, p, p]
    lib.bayes_decide_launch.restype = i
    return lib


def launch_split(rows: int, n_cls: int, n_out: int, fill_threads: int) -> tuple:
    """(threads per stream, streams each thread classifies, rows per tile) of
    one launch.

    A stream's words are shared by the fewest threads, a power of two up to
    ``MAX_SPLIT`` and at most ``n_out``, that give ``fill_threads`` threads in
    all; where that leaves threads to spare, each classifies up to
    ``MAX_CHUNK`` streams before the block hashes the ones that need it.  A
    tile holds as many whole rows (K streams each) as one pass classifies,
    and at least one.
    """
    split = 1
    while 2 * split <= min(MAX_SPLIT, n_out) and rows * n_cls * split < fill_threads:
        split *= 2
    chunk = backend.items_per_thread(rows * n_cls * split, fill_threads, MAX_CHUNK)
    return split, chunk, max(1, THREADS // split * chunk // n_cls)


def bayes_decide_cuda(kd0: int, kd1: int, p: torch.Tensor, *, n_bits: int,
                      offset: int = 0, queued: torch.Tensor | None = None):
    """p (M, R, K) float32 on a CUDA device -> (decisions (R,), counts (R, K)) int32.

    Entropy word ``i`` of stream ``(m, r, k)`` hashes the counter
    ``((m * R + r) * K + k) * n_bits // 4 + i + offset`` (mod 2**32), as
    ``counter_hash_words(key, (M, R, K), n_bits // 4, offset=offset)`` does.
    ``queued``, a one-element int64 tensor on the same device, gains the
    number of streams the launch queues for hashing (one atomic add per
    block); the call does not wait for it.
    """
    if p.device.type != "cuda":
        raise ValueError(f"bayes_decide_cuda needs a CUDA tensor, got {p.device}")
    if p.dtype != torch.float32 or p.dim() != 3 or p.shape[0] < 1:
        raise ValueError(f"p must be (M, R, K) float32 with M >= 1, got "
                         f"{tuple(p.shape)} {p.dtype}")
    if n_bits % 32 or n_bits <= 0:
        raise ValueError(f"n_bits must be a positive multiple of 32, got {n_bits}")
    if queued is not None and (queued.dtype != torch.int64 or queued.numel() != 1
                               or queued.device != p.device):
        raise ValueError(f"queued must be one int64 on {p.device}, got "
                         f"{tuple(queued.shape)} {queued.dtype} on {queued.device}")
    p = p.contiguous()
    m, r, k = p.shape
    if r == 0 or k == 0:
        return (torch.zeros((r,), dtype=torch.int32, device=p.device),
                torch.zeros((r, k), dtype=torch.int32, device=p.device))
    # the kernel stores every count and every decision
    dec = torch.empty((r,), dtype=torch.int32, device=p.device)
    counts = torch.empty((r, k), dtype=torch.int32, device=p.device)
    n_out = n_bits // 32
    split, chunk, rows_per_tile = launch_split(r, k, n_out,
                                               backend.fill_threads(p.device.index or 0))
    lib = library()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.bayes_decide_launch(
            p.data_ptr(), dec.data_ptr(), counts.data_ptr(), m, r, k, n_out,
            kd0 & MASK32, kd1 & MASK32, int(offset) & MASK32, split.bit_length() - 1,
            chunk, rows_per_tile, THREADS, MAX_BLOCKS, stream,
            None if queued is None else queued.data_ptr())
    if err != 0:
        raise RuntimeError(f"bayes_decide kernel launch failed: cudaError {err}")
    bayes_decide_cuda.launches += 1
    return dec, counts


bayes_decide_cuda.launches = 0
