"""Device resolution and the build of the port's hand-written CUDA kernels.

**Devices.**  Every entry point takes an explicit ``device=`` and defaults to
the card.  :func:`resolve_device` raises when CUDA is asked for and absent:
the port never falls back to the CPU behind the caller's back.  On a CPU
tensor a kernel wrapper runs the kernel's plain torch version; on a CUDA
tensor it launches the kernel or raises.

**Builds.**  Each kernel is one ``.cu`` file with a plain C interface under
its package's ``csrc/``, with the headers beside it (or, shared, beside
another kernel's source: the wrapper names those as ``deps``).  :func:`load_library`
compiles it with ``nvcc`` for ``sm_90a`` into ``build/`` at the repository
root (listed in ``.gitignore``) on first use, and loads it with ``ctypes``.
A library is rebuilt when its source or a header changes (the file name
carries a hash of them and the flags).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def resolve_device(device) -> torch.device:
    """``device`` -> torch.device; raises if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} asks for CUDA, but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain torch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return dev


@functools.lru_cache(maxsize=None)
def fill_threads(index: int) -> int:
    """Threads resident at once on CUDA device ``index``: every SM full."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count * props.max_threads_per_multi_processor


def items_per_thread(items: int, fill: int, most: int) -> int:
    """Items each thread of a launch takes, 1 up to ``most``: as many as still
    leave ``fill`` threads (or one each where there are fewer items)."""
    return max(1, min(most, items // fill))


def pick_block(rows: int, preferred: int) -> int:
    """Largest block size from the standard ladder that tiles ``rows`` exactly."""
    for cand in (preferred, 256, 128, 64, 32, 8):
        if cand <= rows and rows % cand == 0:
            return cand
    return 1


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda`` or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def build_library(source: pathlib.Path, extra_flags=(), deps=()) -> tuple:
    """Compile one ``.cu`` file into ``build/``; returns (path, nvcc log).

    ``-Xptxas -v`` is always passed, so the log reports each kernel's
    registers, shared memory and spills.  ``deps`` are the headers the source
    includes from elsewhere; they and the headers beside the source join the
    hash that names the library.
    """
    source = pathlib.Path(source)
    flags = NVCC_FLAGS + ("-Xptxas", "-v") + tuple(extra_flags)
    deps = tuple(deps) + tuple(sorted(source.parent.glob("*.h")))
    text = source.read_bytes() + b"".join(pathlib.Path(d).read_bytes() for d in deps)
    digest = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()
    out = BUILD_DIR / f"{source.stem}-{digest[:16]}.so"
    log_path = out.with_suffix(".log")
    if out.exists() and log_path.exists():
        return out, log_path.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [nvcc_path(), *flags, "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{log}")
    os.replace(tmp, out)
    log_path.write_text(log)
    return out, log


def load_library(source: pathlib.Path, deps=()) -> ctypes.CDLL:
    """Build (once per version of the source and its headers) and load a
    kernel library; ``deps`` as for :func:`build_library`."""
    path, _ = build_library(source, deps=deps)
    return ctypes.CDLL(str(path))
