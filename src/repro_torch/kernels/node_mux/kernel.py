"""Wrappers of the hand-written CUDA ``node_mux`` kernels (``csrc/node_mux.cu``).

Replace the TPU kernels of ``repro/kernels/node_mux/kernel.py``:
``node_mux_gather_cuda`` <- ``_node_mux_gather_kernel``, ``node_mux_cat_cuda``
<- ``_node_mux_cat_kernel`` and ``node_mux_rows_cuda`` <- ``_node_mux_kernel``.
Each kernel hashes its entropy words in registers from the two seed words of
the node's key and a counter origin, so the caller passes no entropy tensor.
They run on the current CUDA stream and do not synchronise; a refused launch
raises here.  Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.core import bitops
from repro_torch.kernels import backend

SOURCE = pathlib.Path(__file__).parent / "csrc" / "node_mux.cu"
THREADS = 256
MAX_PARENTS = 6            # binary kernels: MAX_M of the source


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, with its C signatures declared."""
    lib = backend.load_library(SOURCE)
    p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    for name in ("node_mux_gather_launch", "node_mux_rows_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, ll, i, i, u, u, u, i, p]
        fn.restype = i
    lib.node_mux_cat_launch.argtypes = [p, p, p, ll, i, p, i, u, u, u, i, p]
    lib.node_mux_cat_launch.restype = i
    return lib


def _check_words(parents: torch.Tensor, n_planes: int, rows: int, n_bits: int, what: str):
    if parents.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got parents on {parents.device}")
    if n_bits % 32 or n_bits <= 0:
        raise ValueError(f"n_bits must be a positive multiple of 32, got {n_bits}")
    want = (n_planes, rows, n_bits // 32)
    if parents.dtype != torch.int32 or tuple(parents.shape) != want:
        raise ValueError(f"{what}: parents must be int32 {want}, got "
                         f"{parents.dtype} {tuple(parents.shape)}")


def _binary(launcher: str, counter, kd0: int, kd1: int, cpt: torch.Tensor,
            parents: torch.Tensor, n_bits: int, offset: int) -> torch.Tensor:
    if cpt.device.type != "cuda" or cpt.dtype != torch.float32 or cpt.dim() != 2:
        raise ValueError(f"cpt must be (R, L) float32 on a CUDA device, got "
                         f"{tuple(cpt.shape)} {cpt.dtype} on {cpt.device}")
    rows, n_leaves = cpt.shape
    m = n_leaves.bit_length() - 1
    if n_leaves != 1 << m:
        raise ValueError(f"{n_leaves} CPT rows is not a power of two")
    if m > MAX_PARENTS:
        raise ValueError(f"the CUDA node_mux kernels take at most {MAX_PARENTS} "
                         f"binary parents, got {m}")
    _check_words(parents, m, rows, n_bits, launcher)
    cpt, parents = cpt.contiguous(), parents.contiguous()
    n_out = n_bits // 32
    out = torch.empty((rows, n_out), dtype=torch.int32, device=cpt.device)
    if rows == 0:
        return out
    with torch.cuda.device(cpt.device):
        stream = torch.cuda.current_stream(cpt.device).cuda_stream
        err = getattr(library(), launcher)(
            cpt.data_ptr(), parents.data_ptr(), out.data_ptr(), rows, n_out, m,
            kd0 & bitops.MASK32, kd1 & bitops.MASK32, int(offset) & bitops.MASK32,
            THREADS, stream)
    if err != 0:
        raise RuntimeError(f"{launcher} failed: cudaError {err}")
    counter.launches += 1
    return out


def node_mux_gather_cuda(kd0: int, kd1: int, cpt: torch.Tensor, parents: torch.Tensor, *,
                         n_bits: int, offset: int = 0) -> torch.Tensor:
    """Threshold-gather: cpt (R, 2**m) float32, parents (m, R, n_bits // 32)
    int32 -> (R, n_bits // 32) int32.  Entropy word ``i`` of row ``r`` hashes
    the counter ``r * n_bits // 4 + i + offset`` (mod 2**32).
    """
    return _binary("node_mux_gather_launch", node_mux_gather_cuda, kd0, kd1, cpt,
                   parents, n_bits, offset)


def node_mux_rows_cuda(kd0: int, kd1: int, cpt: torch.Tensor, parents: torch.Tensor, *,
                       n_bits: int, offset: int = 0) -> torch.Tensor:
    """Row-encode: as :func:`node_mux_gather_cuda`, but every CPT row ``l``
    draws its own entropy, counters ``(r * L + l) * n_bits // 4 + i + offset``.
    """
    return _binary("node_mux_rows_launch", node_mux_rows_cuda, kd0, kd1, cpt,
                   parents, n_bits, offset)


def node_mux_cat_cuda(kd0: int, kd1: int, cdf: torch.Tensor, parents: torch.Tensor, *,
                      cards: tuple, n_bits: int, offset: int = 0) -> torch.Tensor:
    """Categorical gather: cdf (R, L, k-1) int32 thresholds in [0, 256],
    parents (P, R, n_bits // 32) int32 value bit-planes (P may be 0)
    -> (value_bits(k), R, n_bits // 32) int32.  ``cards = (k, k_p0, ..)``.
    Counters as in :func:`node_mux_gather_cuda`.
    """
    k = int(cards[0])
    pcards = tuple(int(c) for c in cards[1:])
    n_leaves = 1
    for c in pcards:
        n_leaves *= c
    n_planes = sum(bitops.value_bits(c) for c in pcards)
    if cdf.device.type != "cuda" or cdf.dim() != 3 or \
            tuple(cdf.shape[1:]) != (n_leaves, k - 1):
        raise ValueError(f"cdf must be (R, {n_leaves}, {k - 1}) on a CUDA device, got "
                         f"{tuple(cdf.shape)} on {cdf.device}")
    rows = cdf.shape[0]
    _check_words(parents, n_planes, rows, n_bits, "node_mux_cat")
    cdf = cdf.to(torch.int32).contiguous()
    parents = parents.contiguous()
    n_out = n_bits // 32
    out = torch.empty((bitops.value_bits(k), rows, n_out), dtype=torch.int32,
                      device=cdf.device)
    if rows == 0:
        return out
    card_arr = (ctypes.c_int * (1 + len(pcards)))(k, *pcards)
    with torch.cuda.device(cdf.device):
        stream = torch.cuda.current_stream(cdf.device).cuda_stream
        err = library().node_mux_cat_launch(
            cdf.data_ptr(), parents.data_ptr(), out.data_ptr(), rows, n_out, card_arr,
            len(pcards), kd0 & bitops.MASK32, kd1 & bitops.MASK32,
            int(offset) & bitops.MASK32, THREADS, stream)
    if err != 0:
        raise RuntimeError(f"node_mux_cat_launch failed: cudaError {err}")
    node_mux_cat_cuda.launches += 1
    return out


node_mux_gather_cuda.launches = 0
node_mux_rows_cuda.launches = 0
node_mux_cat_cuda.launches = 0
