"""Wrapper of the hand-written CUDA ``net_sweep`` kernel (``csrc/net_sweep.cu``).

Replaces the TPU kernel ``repro/kernels/net_sweep/kernel.py::net_sweep_pallas``.
The library is built with ``nvcc`` on first use (``kernels.backend``); the
plan's gate program is uploaded once per ``(plan, w_words, device)`` and
cached.  The kernel runs on the current CUDA stream and does not synchronise;
a refused launch raises here.  ``net_sweep_cuda.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.net_sweep.common import SweepPlan
from repro_torch.kernels.net_sweep.program import record_program

SOURCE = pathlib.Path(__file__).parent / "csrc" / "net_sweep.cu"
THREADS = 256


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, with its C signatures declared."""
    lib = backend.load_library(SOURCE)
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.net_sweep_launch.argtypes = [
        p, i, i, p, i, p, i, i, p, i, i, i, i, u, u, u, u, i, i, i, p,
    ]
    lib.net_sweep_launch.restype = i
    lib.net_sweep_max_smem.argtypes = []
    lib.net_sweep_max_smem.restype = i
    return lib


@functools.lru_cache(maxsize=256)
def _device_program(plan: SweepPlan, w_words: int, device: torch.device):
    """The gate program and query cardinalities, resident on ``device``."""
    prog = record_program(plan, w_words)
    code = torch.from_numpy(prog.code).to(device)
    qcards = torch.tensor(plan.query_cards, dtype=torch.int32, device=device)
    return prog, code, qcards


def launch_config(n_slots: int, n_out: int, w_words: int, max_smem: int):
    """(threads, frames_per_block, shared bytes) for one launch.

    A block covers whole frames: at least one, and enough to give every
    thread an item when frames are short.  Threads shrink from 256 when the
    program's live words do not fit in shared memory.
    """
    threads = THREADS
    while True:
        fpb = max(1, -(-threads // w_words))
        smem = 4 * (n_slots * threads + fpb * n_out)
        if smem <= max_smem:
            return threads, fpb, smem
        if threads == 32:
            raise ValueError(
                f"gate program needs {n_slots} live words per thread: "
                f"{smem} bytes of shared memory exceed the block's {max_smem}"
            )
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
    lib = library()
    with torch.cuda.device(ev.device):
        prog, code, qcards = _device_program(plan, w_words, ev.device)
        threads, fpb, smem = launch_config(
            prog.n_slots, prog.n_out, w_words, lib.net_sweep_max_smem())
        stream = torch.cuda.current_stream(ev.device).cuda_stream
        err = lib.net_sweep_launch(
            code.data_ptr(), code.shape[0], prog.n_slots, ev.data_ptr(),
            ev.shape[1], out.data_ptr(), n_cols, n_s, qcards.data_ptr(), n_q,
            int(decide), b, w_words, kd0 & 0xFFFFFFFF, kd1 & 0xFFFFFFFF,
            int(frame0) & 0xFFFFFFFF, total & 0xFFFFFFFF, fpb, threads, smem,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"net_sweep kernel launch failed: cudaError {err}")
    net_sweep_cuda.launches += 1
    return _split(out, n_s, decide)


net_sweep_cuda.launches = 0


def _split(out, n_s, decide):
    numer, denom = out[:, :n_s], out[:, n_s]
    if decide:
        return numer, denom, out[:, n_s + 1 :]
    return numer, denom
