"""Wrapper of the per-plan CUDA ``net_sweep`` kernel (``csrc/net_sweep_kernel.cuh``).

Replaces the TPU kernel ``repro/kernels/net_sweep/kernel.py::net_sweep_pallas``.
Each gate program (one per plan, whatever its ``n_bits``) is its own kernel
library: :mod:`.codegen` writes its source into ``build/`` (named by a hash
of the text), ``nvcc`` compiles it through ``backend.build_library`` and
ctypes loads it.  Libraries are cached in the process by that hash, so plans
whose programs are identical share one.  :func:`prepare` builds ahead of the first
launch (``compile_network(..., device="cuda")`` calls it); a launch with a
plan not yet built builds first.  ``net_sweep_cuda.launches`` counts the
launches and ``net_sweep_cuda.builds`` the libraries this process loaded;
``BUILDS`` holds each one's nvcc seconds, log and library path.

The kernel runs on the current CUDA stream and does not synchronise; a
refused launch raises here.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import pathlib
import threading
import time

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.net_sweep import codegen
from repro_torch.kernels.net_sweep.common import SweepPlan

CSRC = pathlib.Path(__file__).parent / "csrc"
HEADERS = (CSRC / "net_sweep_common.h", CSRC / "net_sweep_kernel.cuh")
THREADS = 128
MAX_SMEM = 227 * 1024         # dynamic shared memory a block can opt into (H100)

_LIBS = {}                    # source hash -> loaded library
_LOCKS = {}                   # source hash -> lock held while it builds
BUILDS = {}                   # source hash -> {"seconds": nvcc wall time, "log": ...}


@functools.lru_cache(maxsize=256)
def program_source(plan: SweepPlan) -> str:
    """The CUDA translation unit of one plan."""
    return codegen.cuda_source(plan)


def program_key(plan: SweepPlan) -> str:
    """The hash of one plan's source text: its key in ``BUILDS`` and its
    ``build/net_sweep_<key>.cu`` file name."""
    return hashlib.sha256(program_source(plan).encode()).hexdigest()[:16]


def _load(text: str) -> ctypes.CDLL:
    key = hashlib.sha256(text.encode()).hexdigest()[:16]
    with _LOCKS.setdefault(key, threading.Lock()):
        if key in _LIBS:
            return _LIBS[key]
        src = backend.BUILD_DIR / f"net_sweep_{key}.cu"
        if not src.exists():
            backend.BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = src.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            tmp.write_text(text)
            os.replace(tmp, src)
        t0 = time.perf_counter()
        path, log = backend.build_library(src, ("-I", str(CSRC)), deps=HEADERS)
        BUILDS[key] = {"seconds": time.perf_counter() - t0, "log": log, "source": src.name,
                       "library": path}
        lib = ctypes.CDLL(str(path))
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        lib.net_sweep_launch.argtypes = [p, i, p, i, i, i, i, u, u, u, u, i, i, i, p]
        lib.net_sweep_launch.restype = i
        _LIBS[key] = lib
        net_sweep_cuda.builds += 1
        return lib


@functools.lru_cache(maxsize=256)
def program_library(plan: SweepPlan) -> ctypes.CDLL:
    """The loaded kernel library of one plan; builds it once.  Cached by the
    plan, so a launch hashes no source text."""
    return _load(program_source(plan))


def prepare(plans) -> list:
    """Build the libraries of ``plans``, one nvcc each, in parallel (as many
    at once as the process has cores); returns them in order."""
    plans = list(plans)
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()
    workers = max(1, min(len(plans), cores or 1))
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        return list(pool.map(program_library, plans))


@functools.lru_cache(maxsize=256)
def launch_config(n_out: int, w_words: int, max_smem: int = MAX_SMEM):
    """(threads, frames_per_block, shared bytes) for one launch.

    A block covers whole frames: at least one, and enough to give every
    thread an item when frames are short.  Shared memory holds only the
    frames' counts; threads shrink from ``THREADS`` if they do not fit.
    """
    threads = THREADS
    while True:
        fpb = max(1, -(-threads // w_words))
        smem = 4 * fpb * n_out
        if smem <= max_smem:
            return threads, fpb, smem
        if threads == 32:
            raise ValueError(f"{n_out} count columns of {fpb} frames need {smem} bytes "
                             f"of shared memory, more than the block's {max_smem}")
        threads //= 2


def net_sweep_cuda(
    kd0: int,
    kd1: int,
    ev: torch.Tensor,
    *,
    plan: SweepPlan,
    n_bits: int,
    frame0: int = 0,
    total_frames: int | None = None,
    decide: bool = False,
):
    """Launch the kernel: ev (B, n_ev) int32 on a CUDA device
    -> (numer (B, n_value_slots), denom (B,)[, decisions (B, n_q)]) int32."""
    if ev.device.type != "cuda":
        raise ValueError(f"net_sweep_cuda needs a CUDA tensor, got {ev.device}")
    if ev.dtype != torch.int32 or ev.dim() != 2 or ev.shape[1] != len(plan.evidence):
        raise ValueError(f"evidence must be (B, {len(plan.evidence)}) int32, "
                         f"got {tuple(ev.shape)} {ev.dtype}")
    if n_bits % 32 or n_bits <= 0:
        raise ValueError("n_bits must be a positive multiple of 32")
    ev = ev.contiguous()
    b = ev.shape[0]
    w_words = n_bits // 32
    total = b if total_frames is None else int(total_frames)
    n_s, n_q = plan.n_value_slots, len(plan.queries)
    n_cols = n_s + 1 + (n_q if decide else 0)
    out = torch.empty((b, n_cols), dtype=torch.int32, device=ev.device)
    if b == 0:
        return _split(out, n_s, decide)
    lib = program_library(plan)
    threads, fpb, smem = launch_config(n_s + 1, w_words)
    with torch.cuda.device(ev.device):
        stream = torch.cuda.current_stream(ev.device).cuda_stream
        err = lib.net_sweep_launch(
            ev.data_ptr(), ev.shape[1], out.data_ptr(), n_cols, int(decide), b, w_words,
            kd0 & 0xFFFFFFFF, kd1 & 0xFFFFFFFF, int(frame0) & 0xFFFFFFFF,
            total & 0xFFFFFFFF, fpb, threads, smem, stream,
        )
    if err != 0:
        raise RuntimeError(f"net_sweep kernel launch failed: cudaError {err}")
    net_sweep_cuda.launches += 1
    return _split(out, n_s, decide)


net_sweep_cuda.launches = 0
net_sweep_cuda.builds = 0


def _split(out, n_s, decide):
    numer, denom = out[:, :n_s], out[:, n_s]
    if decide:
        return numer, denom, out[:, n_s + 1 :]
    return numer, denom
