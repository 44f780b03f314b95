"""Packed stochastic logic: the value-select MUX tree of the unfused lowering.

Only :func:`mux_select` is ported so far; the reference's encoders of
correlated pairs, the gate motifs and ``mux_tree`` wait for ROADMAP queue 1
item 12.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitops


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
