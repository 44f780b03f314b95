"""Deterministic, resumable synthetic data pipeline.

Every batch is a pure function of (seed, step): restart/elastic-resize needs no
iterator state -- a restored job at step N regenerates batch N exactly, and a
resharded job slices the same global batch differently.  Host-sharded loading is
modelled by ``host_slice``; a background prefetch thread keeps ``depth`` batches
ready (compute/IO overlap).

The draws are the reference's: tokens and labels from ``fold_in``, ``split``
and ``randint`` on the host (``core.prng``), bit for bit, then moved to the
device; the stub frontends' ``extra_embeds`` from ``prng.normal`` on the
device, within a few ulp of ``jax.random.normal``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.kernels.backend import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    vocab_size: int = 512
    # multimodal stubs
    frontend: str = "none"       # none | patch | frame
    n_extra: int = 0             # patch count / frame count
    d_model: int = 0


def batch_at_step(cfg: DataConfig, step: int, *, device="cuda") -> Dict[str, torch.Tensor]:
    """Global batch for ``step`` on ``device`` (pure function -- the
    resumability contract): int32 ``tokens`` and ``labels``, float32
    ``extra_embeds`` for the stub frontends.

    Synthetic LM data with learnable structure: a shifted-window token process
    (next token depends on the previous one), so small models can overfit and
    integration tests can assert loss decreases.
    """
    dev = resolve_device(device)
    key = prng.fold_in(prng.PRNGKey(cfg.seed), step)
    k1, k2, k3 = prng.split(key, 3)
    shape = (cfg.global_batch, cfg.seq_len)
    base = prng.randint(k1, shape, 0, max(cfg.vocab_size // 4, 2))
    drift = np.cumsum(prng.randint(k2, shape, 0, 2), axis=1, dtype=np.int32)
    tokens = (base + drift) % np.int32(cfg.vocab_size)
    labels = np.roll(tokens, -1, axis=1)
    out = {"tokens": torch.from_numpy(tokens).to(dev), "labels": torch.from_numpy(labels).to(dev)}
    if cfg.frontend in ("patch", "frame") and cfg.n_extra and cfg.d_model:
        out["extra_embeds"] = (
            prng.normal(k3, (cfg.global_batch, cfg.n_extra, cfg.d_model), device=dev)
            * torch.tensor(np.float32(0.02), device=dev)
        )
    return out


def host_slice(batch: Dict[str, torch.Tensor], host_id: int, n_hosts: int):
    """The shard of the global batch this host would load (multi-host posture)."""
    def sl(x):
        per = x.shape[0] // n_hosts
        return x[host_id * per : (host_id + 1) * per]

    return {k: sl(v) for k, v in batch.items()}


class Prefetcher:
    """Background-thread prefetch of ``depth`` upcoming batches, made on the
    host and yielded as ``(step, {name: numpy array})``; the caller moves them
    to its device."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2):
        self.cfg = cfg
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step, batch = self._step, None
        while not self._stop.is_set():
            if batch is None:
                batch = {k: v.numpy()
                         for k, v in batch_at_step(self.cfg, step, device="cpu").items()}
            try:
                self._q.put((step, batch), timeout=0.5)
            except queue.Full:
                continue
            step, batch = step + 1, None

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
