"""Wrappers of the hand-written CUDA ``node_mux`` kernels (``csrc/node_mux.cu``).

Replace the TPU kernels of ``repro/kernels/node_mux/kernel.py``:
``node_mux_gather_cuda`` <- ``_node_mux_gather_kernel``, ``node_mux_cat_cuda``
<- ``_node_mux_cat_kernel`` and ``node_mux_rows_cuda`` <- ``_node_mux_kernel``.
Each kernel hashes its entropy words in registers from the two seed words of
the node's key and a counter origin, so the caller passes no entropy tensor.

The node's shape picks the kernel before the launch, and each path is its
own wrapper with its own ``.launches`` count:

* ``node_mux_gather_cuda`` / ``node_mux_rows_cuda``: at most
  ``MAX_PARENTS`` binary parents, one kernel templated on the parent count
  whose per-word bodies live in ``csrc/node_mux_body.h``.  Per entropy word
  it builds a nibble selector of the 4 positions' CPT rows from whole parent
  words, fetches their thresholds with byte permutes from registers (a shared
  table is rounded once per block), compares the 4 bytes in one SWAR step
  and packs them with one multiply; row-encode hashes only the entropy word
  of the row each position selects (from 2 parents on).  A wider gather runs
  on the categorical kernels at k = 2 (on ``ref.binary_cat_table``, which
  rounds the CPT exactly as the gather kernel does; a compiled network folds
  it once), a wider row encode on ``node_mux_rows_wide_cuda``.
* ``node_mux_cat_cuda``: the pattern-table kernel for at most
  ``ref.PATTERN_PLANES`` parent bit-planes; wider nodes go to
  ``node_mux_cat_wide_cuda``, which decodes the digits at run time.

A table is given per row, ``(R, ...)``, or once for every row: without the
row axis, or as a broadcast view whose row stride is 0.  A shared table is
passed to the kernel with row stride 0 and never copied per row.  The
kernels run on the current CUDA stream and do not synchronise; a refused
launch raises here.
"""

from __future__ import annotations

import ctypes
import functools
import math
import pathlib

import torch

from repro_torch.core import bitops
from repro_torch.kernels import backend
from repro_torch.kernels.node_mux.ref import PATTERN_PLANES, binary_cat_table

SOURCE = pathlib.Path(__file__).parent / "csrc" / "node_mux.cu"
THREADS = 256
MAX_PARENTS = 6            # templated binary kernels: MAX_M of the source
MAX_WIDE = 63              # wide kernels: a node this wide has >= 2**63 CPT rows


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, with its C signatures declared."""
    lib = backend.load_library(SOURCE)
    p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    for name in ("node_mux_gather_launch", "node_mux_rows_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [p, ll, p, p, ll, i, i, u, u, u, i, p]
        fn.restype = i
    lib.node_mux_rows_wide_launch.argtypes = [p, ll, p, p, ll, i, i, u, u, u, i, p]
    lib.node_mux_rows_wide_launch.restype = i
    lib.node_mux_cat_launch.argtypes = [p, ll, i, i, p, p, ll, i, i, u, u, u, i, p]
    lib.node_mux_cat_launch.restype = i
    lib.node_mux_cat_wide_launch.argtypes = [p, ll, i, i, p, i, p, p, ll, i, u, u, u, i, p]
    lib.node_mux_cat_wide_launch.restype = i
    return lib


def _check_words(parents: torch.Tensor, n_planes: int, n_bits: int, what: str) -> int:
    """Validates (n_planes, R, n_bits // 32) int32 parents on the card; returns R."""
    if parents.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got parents on {parents.device}")
    if n_bits % 32 or n_bits <= 0:
        raise ValueError(f"n_bits must be a positive multiple of 32, got {n_bits}")
    if parents.dtype != torch.int32 or parents.dim() != 3 or \
            tuple(parents.shape[::2]) != (n_planes, n_bits // 32):
        raise ValueError(f"{what}: parents must be int32 ({n_planes}, R, {n_bits // 32}), got "
                         f"{parents.dtype} {tuple(parents.shape)}")
    return parents.shape[1]


def _row_table(table: torch.Tensor, inner: tuple, rows: int, dtype, what: str):
    """(contiguous table, row stride in elements): stride 0 for one shared table."""
    if table.device.type != "cuda":
        raise ValueError(f"{what}: the table must be on a CUDA device, got {table.device}")
    if table.dim() == len(inner) + 1 and table.shape[0] == rows and table.stride(0) == 0:
        table = table[0]
    if tuple(table.shape) == inner:
        return table.to(dtype).contiguous(), 0
    if tuple(table.shape) != (rows,) + inner:
        raise ValueError(f"{what}: table must be {inner} or ({rows},) + {inner}, "
                         f"got {tuple(table.shape)}")
    return table.to(dtype).contiguous(), math.prod(inner)


def _cpt_parents(cpt: torch.Tensor, parents: torch.Tensor, n_bits: int, what: str):
    if cpt.dtype != torch.float32 or cpt.dim() not in (1, 2):
        raise ValueError(f"{what}: cpt must be (R, L) or (L,) float32, got "
                         f"{tuple(cpt.shape)} {cpt.dtype}")
    n_leaves = cpt.shape[-1]
    m = n_leaves.bit_length() - 1
    if n_leaves != 1 << m:
        raise ValueError(f"{n_leaves} CPT rows is not a power of two")
    rows = _check_words(parents, m, n_bits, what)
    cpt, stride = _row_table(cpt, (n_leaves,), rows, torch.float32, what)
    return cpt, stride, m, rows


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _launched(counter, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError {err}")
    counter.launches += 1


def _binary(launcher: str, counter, kd0: int, kd1: int, cpt: torch.Tensor,
            parents: torch.Tensor, n_bits: int, offset: int) -> torch.Tensor:
    cpt, stride, m, rows = _cpt_parents(cpt, parents, n_bits, launcher)
    parents = parents.contiguous()
    n_out = n_bits // 32
    out = torch.empty((rows, n_out), dtype=torch.int32, device=parents.device)
    if rows == 0:
        return out
    with torch.cuda.device(parents.device):
        err = getattr(library(), launcher)(
            cpt.data_ptr(), stride, parents.data_ptr(), out.data_ptr(), rows, n_out, m,
            kd0 & bitops.MASK32, kd1 & bitops.MASK32, int(offset) & bitops.MASK32,
            THREADS, _stream(parents.device))
    _launched(counter, err, launcher)
    return out


def node_mux_gather_cuda(kd0: int, kd1: int, cpt: torch.Tensor, parents: torch.Tensor, *,
                         n_bits: int, offset: int = 0) -> torch.Tensor:
    """Threshold-gather: cpt (R, 2**m) or (2**m,) float32, parents
    (m, R, n_bits // 32) int32 -> (R, n_bits // 32) int32.  Entropy word
    ``i`` of row ``r`` hashes the counter ``r * n_bits // 4 + i + offset``
    (mod 2**32).  More than ``MAX_PARENTS`` parents run on the categorical
    kernels at k = 2, on the table :func:`ref.binary_cat_table` folds here,
    per call (a compiled network passes its folded table to
    :func:`node_mux_cat_cuda` itself).
    """
    if parents.dim() == 3 and parents.shape[0] > MAX_PARENTS:
        if cpt.dtype != torch.float32 or cpt.dim() not in (1, 2):
            raise ValueError(f"cpt must be (R, L) or (L,) float32, got {tuple(cpt.shape)} "
                             f"{cpt.dtype}")
        if cpt.dim() == 2 and cpt.stride(0) == 0:
            cpt = cpt[0]
        cards = (2,) * (parents.shape[0] + 1)
        return node_mux_cat_cuda(kd0, kd1, binary_cat_table(cpt), parents, cards=cards,
                                 n_bits=n_bits, offset=offset)[0]
    return _binary("node_mux_gather_launch", node_mux_gather_cuda, kd0, kd1, cpt,
                   parents, n_bits, offset)


def node_mux_rows_cuda(kd0: int, kd1: int, cpt: torch.Tensor, parents: torch.Tensor, *,
                       n_bits: int, offset: int = 0) -> torch.Tensor:
    """Row-encode: as :func:`node_mux_gather_cuda`, but every CPT row ``l``
    draws its own entropy, counters ``(r * L + l) * n_bits // 4 + i + offset``.
    More than ``MAX_PARENTS`` parents run on :func:`node_mux_rows_wide_cuda`.
    """
    if parents.dim() == 3 and parents.shape[0] > MAX_PARENTS:
        return node_mux_rows_wide_cuda(kd0, kd1, cpt, parents, n_bits=n_bits, offset=offset)
    return _binary("node_mux_rows_launch", node_mux_rows_cuda, kd0, kd1, cpt,
                   parents, n_bits, offset)


def node_mux_rows_wide_cuda(kd0: int, kd1: int, cpt: torch.Tensor, parents: torch.Tensor, *,
                            n_bits: int, offset: int = 0) -> torch.Tensor:
    """:func:`node_mux_rows_cuda` for any parent count: per stream position
    only the entropy word of the CPT row the parents select is hashed."""
    if parents.dim() == 3 and parents.shape[0] > MAX_WIDE:
        raise ValueError(f"{parents.shape[0]} parents need 2**{parents.shape[0]} CPT rows")
    return _binary("node_mux_rows_wide_launch", node_mux_rows_wide_cuda, kd0, kd1, cpt,
                   parents, n_bits, offset)


def node_mux_cat_cuda(kd0: int, kd1: int, table: torch.Tensor, parents: torch.Tensor, *,
                      cards: tuple, n_bits: int, offset: int = 0) -> torch.Tensor:
    """Categorical gather on the node's ``ref.cat_table`` form: the pattern
    table (R, 2**P, k-1) int16 (or one (2**P, k-1) for every row), P the
    parent value bit-planes, ``cards = (k, k_p0, ..)``; parents (P, R,
    n_bits // 32) int32 (P may be 0) -> (value_bits(k), R, n_bits // 32)
    int32.  Counters as in :func:`node_mux_gather_cuda`.  More than
    ``ref.PATTERN_PLANES`` planes run on :func:`node_mux_cat_wide_cuda`.
    """
    if sum(bitops.value_bits(int(c)) for c in cards[1:]) > PATTERN_PLANES:
        return node_mux_cat_wide_cuda(kd0, kd1, table, parents, cards=cards, n_bits=n_bits,
                                      offset=offset)
    return _cat(kd0, kd1, table, parents, cards, n_bits, offset, False, node_mux_cat_cuda)


def node_mux_cat_wide_cuda(kd0: int, kd1: int, cdf: torch.Tensor, parents: torch.Tensor, *,
                           cards: tuple, n_bits: int, offset: int = 0) -> torch.Tensor:
    """Categorical gather for any parent count: cdf (R, L, k-1) or
    (L, k-1) thresholds in [0, 256], L the product of the parent cards; the
    kernel decodes the parents' digits at run time."""
    return _cat(kd0, kd1, cdf, parents, cards, n_bits, offset, True, node_mux_cat_wide_cuda)


def _cat(kd0, kd1, table, parents, cards, n_bits, offset, wide, counter) -> torch.Tensor:
    """Launch the pattern-table kernel, or with ``wide`` the run-time decode."""
    k = int(cards[0])
    pcards = tuple(int(c) for c in cards[1:])
    n_planes = sum(bitops.value_bits(c) for c in pcards)
    what = counter.__name__
    if not 2 <= k <= 256:
        raise ValueError(f"{what}: cardinality {k} outside [2, 256]")
    if len(pcards) > MAX_WIDE:
        raise ValueError(f"{what}: {len(pcards)} parents need at least 2**{len(pcards)} "
                         "CPT rows")
    rows = _check_words(parents, n_planes, n_bits, what)
    n_tab = math.prod(pcards) if wide else 1 << n_planes
    table, stride = _row_table(table, (n_tab, k - 1), rows,
                               torch.int32 if wide else torch.int16, what)
    parents = parents.contiguous()
    n_out, vb = n_bits // 32, bitops.value_bits(k)
    out = torch.empty((vb, rows, n_out), dtype=torch.int32, device=parents.device)
    if rows == 0:
        return out
    keys = (kd0 & bitops.MASK32, kd1 & bitops.MASK32, int(offset) & bitops.MASK32)
    with torch.cuda.device(parents.device):
        if wide:
            card_arr = (ctypes.c_int * max(1, len(pcards)))(*pcards)
            err = library().node_mux_cat_wide_launch(
                table.data_ptr(), stride, k - 1, vb, card_arr, len(pcards), parents.data_ptr(),
                out.data_ptr(), rows, n_out, *keys, THREADS, _stream(parents.device))
        else:
            err = library().node_mux_cat_launch(
                table.data_ptr(), stride, k - 1, vb, parents.data_ptr(), out.data_ptr(), rows,
                n_out, n_planes, *keys, THREADS, _stream(parents.device))
    _launched(counter, err, what)
    return out


node_mux_gather_cuda.launches = 0
node_mux_rows_cuda.launches = 0
node_mux_cat_cuda.launches = 0
node_mux_rows_wide_cuda.launches = 0
node_mux_cat_wide_cuda.launches = 0
