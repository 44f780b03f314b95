"""The benchmark's input generators: everything a run hands the program comes
from ``--seed`` through here.

* :func:`class_posteriors` -- per-pixel class maps for the fusion operators:
  the softmax of N(0, s_m^2) logits, with a scale s_m per modality (a copy of
  ``chip_smoke.py::_class_posteriors``, which used s = 3 for both), made on
  the device with a ``torch.Generator`` in one call per batch.
* :func:`sample_evidence` -- evidence frames drawn from a network's joint by
  ancestral sampling (the method of
  ``src/repro_torch/bayesnet/analytic.py::sample_evidence``), in NumPy, so
  that frames fire as the network predicts its sensors to.
* :func:`call_key` -- a fresh (2,) uint32 key for every batch or call.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.networks import Network

MASK64 = (1 << 64) - 1


def splitmix64(x: int) -> int:
    """One step of SplitMix64: a well-mixed 64-bit value of ``x``."""
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return x ^ (x >> 31)


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    return splitmix64(splitmix64(seed & MASK64) ^ stream) >> 1


def call_key(seed: int, call: int) -> np.ndarray:
    """The key of batch or call ``call``: two 32-bit words."""
    x = splitmix64(stream_seed(seed, 1) ^ splitmix64(call))
    return np.array([x & 0xFFFFFFFF, x >> 32], np.uint32)


def class_posteriors(seed: int, slot: int, shape: tuple, scales, device) -> torch.Tensor:
    """(M, *pixels, K) float32 class maps: per modality m, softmax of N(0, scales[m]^2) logits."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, 100 + slot))
    logits = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    scale = torch.tensor(scales, dtype=torch.float32, device=device)
    logits.mul_(scale.view((-1,) + (1,) * (len(shape) - 1)))
    return torch.softmax(logits, dim=-1)


def sample_evidence(net: Network, seed: int, stream: int, batch: int) -> np.ndarray:
    """(batch, n_ev) int32 evidence frames by ancestral sampling of the joint.

    Each node in topological order draws one float32 uniform u per frame and
    takes ``#{v : u < P(value >= v | parents)}``, its CPT row picked by the
    parents' sampled values.
    """
    rng = np.random.default_rng(stream_seed(seed, stream))
    vals = []
    for n, parents in enumerate(net.parents):
        rows = np.asarray(net.rows[n], np.float32)
        tails = np.cumsum(rows[:, ::-1], axis=-1)[:, ::-1][:, 1:]
        row = np.zeros(batch, np.int64)
        for p in parents:
            row = row * net.cards[p] + vals[p]
        u = rng.random(batch, dtype=np.float32)
        vals.append((u[:, None] < tails[row]).sum(-1))
    return np.stack([vals[e] for e in net.evidence], axis=-1).astype(np.int32)
