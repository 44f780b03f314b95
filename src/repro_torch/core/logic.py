"""Memristor-enabled probabilistic logics (Fig 2d/2e, Table S1).

Stochastic numbers fed through ordinary Boolean gates compute probability
arithmetic; *which* arithmetic depends on the correlation between the input
streams, which the SNEs engineer (shared or parallel entropy).  This module
gives the analytic (Table S1) expectations, the oracles everywhere, and the
gate-level operators that encode their inputs in the requested correlation
mode and apply the packed bitwise gate; :func:`mux_select` and
:func:`mux_tree` are the MUX trees of the network motifs and of fusion.
"""

from __future__ import annotations

import enum
from typing import Tuple

import torch

from repro_torch.core import bitops, prng, rng, sne
from repro_torch.kernels.backend import resolve_device


class Corr(enum.Enum):
    UNCORRELATED = "uncorrelated"
    POSITIVE = "positive"
    NEGATIVE = "negative"


# --- Table S1 analytic relations --------------------------------------------------

def _pair(pa, pb, device):
    dev = resolve_device(device)
    return (torch.as_tensor(pa, dtype=torch.float32, device=dev),
            torch.as_tensor(pb, dtype=torch.float32, device=dev))


def expected_and(pa, pb, mode: Corr, *, device="cuda") -> torch.Tensor:
    pa, pb = _pair(pa, pb, device)
    if mode is Corr.UNCORRELATED:
        return pa * pb
    if mode is Corr.POSITIVE:
        return torch.minimum(pa, pb)
    return torch.clamp(pa + pb - 1.0, min=0.0)


def expected_or(pa, pb, mode: Corr, *, device="cuda") -> torch.Tensor:
    pa, pb = _pair(pa, pb, device)
    if mode is Corr.UNCORRELATED:
        return pa + pb - pa * pb
    if mode is Corr.POSITIVE:
        return torch.maximum(pa, pb)
    return torch.clamp(pa + pb, max=1.0)


def expected_xor(pa, pb, mode: Corr, *, device="cuda") -> torch.Tensor:
    pa, pb = _pair(pa, pb, device)
    if mode is Corr.UNCORRELATED:
        return pa + pb - 2.0 * pa * pb
    if mode is Corr.POSITIVE:
        return torch.abs(pa - pb)
    s = pa + pb
    return torch.where(s <= 1.0, s, 2.0 - s)


def expected_mux(ps, pa, pb, *, device="cuda") -> torch.Tensor:
    """Weighted addition; valid only when the select is uncorrelated with inputs."""
    pa, pb = _pair(pa, pb, device)
    ps = torch.as_tensor(ps, dtype=torch.float32, device=pa.device)
    return (1.0 - ps) * pa + ps * pb


# --- encoding helpers per correlation mode ----------------------------------------

def encode_pair(key, pa, pb, n_bits: int, mode: Corr, *,
                device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode two streams with the requested mutual correlation."""
    pa, pb = _pair(pa, pb, device)
    if mode is Corr.UNCORRELATED:
        ka, kb = prng.split(key)
        return (sne.encode_uncorrelated(ka, pa, n_bits, device=pa.device),
                sne.encode_uncorrelated(kb, pb, n_bits, device=pa.device))
    stacked = torch.stack(torch.broadcast_tensors(pa, pb), dim=-1)
    negate = None
    if mode is Corr.NEGATIVE:
        negate = torch.zeros(stacked.shape, dtype=torch.bool, device=pa.device)
        negate[..., 1] = True
    words = sne.encode_correlated(key, stacked, n_bits, negate=negate, device=pa.device)
    return words[..., 0, :], words[..., 1, :]


# --- gate-level operators -----------------------------------------------------------

def _gate(gate, key, pa, pb, n_bits, mode, device):
    a, b = encode_pair(key, pa, pb, n_bits, mode, device=device)
    c = gate(a, b)
    return c, bitops.decode(c, n_bits), (a, b)


def prob_and(key, pa, pb, n_bits: int, mode: Corr = Corr.UNCORRELATED, *, device="cuda"):
    """Probabilistic AND: returns (stream_c, estimate, (stream_a, stream_b))."""
    return _gate(bitops.band, key, pa, pb, n_bits, mode, device)


def prob_or(key, pa, pb, n_bits: int, mode: Corr = Corr.UNCORRELATED, *, device="cuda"):
    return _gate(bitops.bor, key, pa, pb, n_bits, mode, device)


def prob_xor(key, pa, pb, n_bits: int, mode: Corr = Corr.UNCORRELATED, *, device="cuda"):
    return _gate(bitops.bxor, key, pa, pb, n_bits, mode, device)


def prob_mux(key, ps, pa, pb, n_bits: int, mode_inputs: Corr = Corr.UNCORRELATED, *,
             device="cuda"):
    """Probabilistic MUX (weighted adder).

    The select stream always comes from an independent SNE: Fig S6 shows the
    operation is corrupted if the select correlates with the inputs.  The two
    data inputs may be correlated or not (``mode_inputs``); the output
    probability is unaffected either way.
    """
    ks, kab = prng.split(key)
    s = sne.encode_uncorrelated(ks, ps, n_bits, device=device)
    a, b = encode_pair(kab, pa, pb, n_bits, mode_inputs, device=device)
    c = bitops.bmux(s, a, b)
    return c, bitops.decode(c, n_bits), (s, a, b)


def mux_select(selects: torch.Tensor, leaves: torch.Tensor) -> torch.Tensor:
    """Value-select MUX tree: per bit position t, route ``leaves[idx(t)]_t`` out.

    ``idx(t)`` is the binary number whose bits are the select streams' bits
    at t, ``selects[0]`` the most significant (the Fig S8 CPT ordering with
    the first parent as the high bit).

    selects: (m, ..., n_words) packed select streams.
    leaves:  (..., L, n_words) packed data streams, L = 2**m.
    """
    m = selects.shape[0]
    if leaves.shape[-2] != 1 << m:
        raise ValueError(f"{leaves.shape[-2]} leaves for {m} selects")
    level = leaves
    for j in range(m - 1, -1, -1):
        s = selects[j][..., None, :]
        level = bitops.bmux(s, level[..., 0::2, :], level[..., 1::2, :])
    return level[..., 0, :]


def mux_tree(key, streams: torch.Tensor, n_bits: int, impl: str = "fast"):
    """Balanced MUX tree over ``streams`` (..., K, n_words) with fresh fair selects.

    Output probability = mean of the K input probabilities for K a power of
    two; otherwise zero streams pad K to ``K_pad``, giving ``(1/K_pad) sum``
    (callers account for the scale).  Returns ``(stream, K_pad)``, as the
    reference does.  Runs on ``streams``' device.
    """
    k = streams.shape[-2]
    k_pad = 1 << (k - 1).bit_length()
    if k_pad != k:
        pad = streams.new_zeros(tuple(streams.shape[:-2]) + (k_pad - k, streams.shape[-1]))
        streams = torch.cat([streams, pad], dim=-2)
    level = streams
    while level.shape[-2] > 1:
        key, sub = prng.split(key)
        half = level.shape[-2] // 2
        sel = rng.fair_bits(sub, tuple(level.shape[:-2]) + (half,), n_bits, impl=impl,
                            device=level.device)
        level = bitops.bmux(sel, level[..., 0::2, :], level[..., 1::2, :])
    return level[..., 0, :], k_pad
