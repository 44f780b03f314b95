"""Public wrappers of the node-MUX sweep (the unfused lowering's inner op).

``node_mux`` turns one binary Bayesian-network node into its packed stream;
``node_mux_categorical`` samples a cardinality-k node's value bit-planes.
The binary modes sample the same conditional distribution:

* ``mode='gather'`` (default): gather the node's 8-bit DAC threshold by the
  parents' packed bits, then compare one entropy byte per stream bit.
* ``mode='rows'`` (the statistical baseline): encode all ``2**m`` CPT rows
  with fresh entropy and MUX-select by the parents' packed streams.

The tensors' device decides what runs: on the card the hand-written kernel
(``kernel.py``) hashes its entropy in registers and launches or raises; on
the CPU the plain torch version (``ref.py``) runs on words drawn by
``counter_hash_words``.  The two draw the same words.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitops, rng
from repro_torch.kernels import backend
from repro_torch.kernels.node_mux.kernel import (
    node_mux_cat_cuda,
    node_mux_gather_cuda,
    node_mux_rows_cuda,
)
from repro_torch.kernels.node_mux.ref import (
    node_mux_cat_ref,
    node_mux_gather_ref,
    node_mux_ref,
)


def _check_n_bits(n_bits: int):
    if n_bits % 32 or n_bits <= 0:
        raise ValueError(f"n_bits must be a positive multiple of 32, got {n_bits}")


def node_mux(key, cpt, parents, n_bits: int = 128, *, mode: str = "gather",
             device="cuda") -> torch.Tensor:
    """Lower one binary network node to its packed stream.

    key:     ``(2,)`` uint32 key data (``repro_torch.core.prng``).
    cpt:     (..., L) CPT rows P(node=1 | parent assignment), L = 2**m, first
             parent = most significant bit of the row index.
    parents: (m, ..., n_words) packed parent streams (leading dims match cpt).
    Returns (..., n_words) int32 on ``device``.  Row ``r`` of the flattened
    leading dims draws the counters ``r * n_bits // 4 ..`` (gather) or
    ``(r * L + l) * n_bits // 4 ..`` for CPT row ``l`` (rows).
    """
    _check_n_bits(n_bits)
    if mode not in ("gather", "rows"):
        raise ValueError(f"unknown node_mux mode {mode!r}")
    dev = backend.resolve_device(device)
    cpt = torch.as_tensor(cpt, dtype=torch.float32).to(dev)
    parents = torch.as_tensor(parents).to(dev)
    m, n_leaves = parents.shape[0], cpt.shape[-1]
    if n_leaves != 1 << m:
        raise ValueError(f"{n_leaves} CPT rows for {m} parents")
    lead, w = tuple(cpt.shape[:-1]), n_bits // 32
    if tuple(parents.shape) != (m,) + lead + (w,):
        raise ValueError(f"parents {tuple(parents.shape)} do not match cpt rows {lead}")
    flat_cpt = cpt.reshape(-1, n_leaves)
    flat_par = parents.reshape(m, -1, w)
    rows = flat_cpt.shape[0]
    if dev.type == "cuda":
        kd0, kd1 = rng.seed_words(key)
        launch = node_mux_gather_cuda if mode == "gather" else node_mux_rows_cuda
        out = launch(kd0, kd1, flat_cpt, flat_par, n_bits=n_bits)
    elif mode == "gather":
        rand = rng.counter_hash_words(key, (rows,), n_bits // 4, device=dev)
        out = node_mux_gather_ref(flat_cpt, rand, flat_par)
    else:
        rand = rng.counter_hash_words(key, (rows, n_leaves), n_bits // 4, device=dev)
        out = node_mux_ref(flat_cpt, rand, flat_par)
    return out.reshape(lead + (w,))


def node_mux_categorical(key, cdf, parents, *, cards: tuple, n_bits: int = 128,
                         device="cuda") -> torch.Tensor:
    """Lower one cardinality-``k`` node to its packed value bit-planes.

    cdf:     (..., L, k-1) non-increasing cumulative DAC thresholds per
             mixed-radix CPT row (``rng.cdf_thresholds_int``; L = product of
             parent cardinalities, first parent = most significant digit).
    parents: (P, ..., n_words) packed parent value bit-planes, parent ``j``
             owning ``value_bits(k_j)`` planes, LSB first.  P may be 0 (a
             k-ary root: L = 1).
    cards:   ``(k, k_p0, .., k_pm-1)``.
    Returns ``(value_bits(k),) + lead + (n_words,)`` int32 on ``device``.
    Row ``r`` of the flattened leading dims draws the counters
    ``r * n_bits // 4 ..``.
    """
    _check_n_bits(n_bits)
    dev = backend.resolve_device(device)
    k = int(cards[0])
    pcards = tuple(int(c) for c in cards[1:])
    n_leaves = 1
    for c in pcards:
        n_leaves *= c
    n_planes = sum(bitops.value_bits(c) for c in pcards)
    cdf = torch.as_tensor(cdf).to(device=dev, dtype=torch.int32)
    if tuple(cdf.shape[-2:]) != (n_leaves, k - 1):
        raise ValueError(f"cdf {tuple(cdf.shape)} does not end in ({n_leaves}, {k - 1})")
    lead, w = tuple(cdf.shape[:-2]), n_bits // 32
    parents = torch.as_tensor(parents).to(dev)
    if tuple(parents.shape) != (n_planes,) + lead + (w,):
        raise ValueError(f"parents {tuple(parents.shape)} do not match cdf rows {lead}")
    flat_cdf = cdf.reshape(-1, n_leaves, k - 1)
    rows = flat_cdf.shape[0]
    flat_par = parents.reshape(n_planes, rows, w)
    if dev.type == "cuda":
        kd0, kd1 = rng.seed_words(key)
        out = node_mux_cat_cuda(kd0, kd1, flat_cdf, flat_par, cards=(k,) + pcards,
                                n_bits=n_bits)
    else:
        rand = rng.counter_hash_words(key, (rows,), n_bits // 4, device=dev)
        out = node_mux_cat_ref(flat_cdf, rand, flat_par, (k,) + pcards)
    return out.reshape((out.shape[0],) + lead + (w,))
