"""Plain reference of the fused decision sweep, frame by frame.

The semantics of ``src/repro_torch/kernels/net_sweep/common.py::sweep_tile``
(the counters and bit-planes of ``core/rng.py``) and of the posterior
assembly of ``src/repro_torch/bayesnet/compile.py`` (``_count_assembler``,
``core/cordiv.py::ratio_from_counts``, ``decide_counts``), written out as a
plain walk over stream positions rather than copied gate for gate:

* node ``n`` (topological index) of frame ``f`` draws, for stream word ``w``
  of ``W = n_bits / 32``, the 8 bit-plane words at counter
  ``n * B * W + f * W + w`` (mod 2**32, ``B`` frames in the call); the
  comparator byte at bit ``j`` of the word holds bit ``j`` of plane ``k`` as
  its bit ``k``;
* the node's value there is ``#{v : byte < C_v[row]}``, with ``C`` the CPT
  row's cumulative DAC thresholds and ``row`` the parents' values at the same
  position (first parent most significant);
* a position is accepted where every evidence node takes the frame's value;
  ``accepted`` counts them and each query value ``v >= 1`` counts the
  accepted positions where the query takes ``v``;
* posteriors are float32 ``count / accepted`` (0 where nothing is accepted):
  ``(B, n_q)`` of P(q = 1) when every query is binary, else ``(B, n_q,
  max_k)`` with the value-0 count ``accepted`` minus the others, padded with
  zeros; a decision is the first value of largest count.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import hashing


def counts(net, thresholds, ev: torch.Tensor, frames: torch.Tensor, n_frames: int,
           n_bits: int, key, block: int = 256):
    """(numer (n, n_slots) int64, accepted (n,) int64) of frames ``frames`` of
    a call of ``n_frames`` frames; ``ev`` holds those frames' evidence (n, n_ev)."""
    dev = ev.device
    w_words = n_bits // 32
    kd0, kd1 = hashing.seed_words(key)
    word = torch.arange(w_words, dtype=torch.int64, device=dev)
    bit = torch.arange(32, dtype=torch.int64, device=dev)
    plane = torch.arange(8, dtype=torch.int64, device=dev)
    tables = [torch.tensor(t, dtype=torch.int64, device=dev) for t in thresholds]
    numers, denoms = [], []
    for a in range(0, frames.numel(), block):
        fr = frames[a:a + block].to(device=dev, dtype=torch.int64)
        evb = ev[a:a + block].to(device=dev, dtype=torch.int64)
        vals = []
        for n, parents in enumerate(net.parents):
            ctr = (n * n_frames * w_words + fr[:, None] * w_words + word[None, :]) & hashing.MASK32
            planes = hashing.plane_words(ctr, kd0, kd1)                       # (b, W, 8)
            bits = (planes[:, :, None, :] >> bit[:, None]) & 1                # (b, W, 32, 8)
            byte = (bits << plane).sum(-1)                                    # (b, W, 32)
            row = torch.zeros_like(byte)
            for p in parents:
                row = row * net.cards[p] + vals[p]
            vals.append((byte[..., None] < tables[n][row]).sum(-1))          # (b, W, 32)
        accept = torch.ones_like(vals[0], dtype=torch.bool)
        for col, e in enumerate(net.evidence):
            accept &= vals[e] == evb[:, col, None, None]
        slots = [(accept & (vals[q] == v)).sum((1, 2))
                 for q in net.queries for v in range(1, net.cards[q])]
        numers.append(torch.stack(slots, dim=-1))
        denoms.append(accept.sum((1, 2)))
    return torch.cat(numers).cpu().numpy(), torch.cat(denoms).cpu().numpy()


def _ratio(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """float32 num / den of integer counts, 0 where den is 0."""
    num32 = num.astype(np.float32)
    den32 = np.maximum(den, 1).astype(np.float32)
    return np.where(den > 0, num32 / den32, np.float32(0)).astype(np.float32)


def assemble(net, numer: np.ndarray, denom: np.ndarray):
    """(posteriors, decisions (n, n_q) int32) from the counts."""
    cards = [net.cards[q] for q in net.queries]
    per_query, decisions, off = [], [], 0
    for c in cards:
        slots = numer[:, off:off + c - 1]
        off += c - 1
        full = np.concatenate([(denom - slots.sum(-1))[:, None], slots], axis=-1)
        per_query.append(full)
        decisions.append(np.argmax(full, axis=-1).astype(np.int32))
    dec = np.stack(decisions, axis=-1)
    if all(c == 2 for c in cards):
        return _ratio(numer, denom[:, None]), dec
    kmax = max(cards)
    cols = []
    for full in per_query:
        p = _ratio(full, denom[:, None])
        pad = np.zeros((p.shape[0], kmax - p.shape[1]), np.float32)
        cols.append(np.concatenate([p, pad], axis=-1))
    return np.stack(cols, axis=1), dec
