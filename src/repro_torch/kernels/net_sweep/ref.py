"""Plain torch version of the fused whole-network sweep.

One call of :func:`~.common.sweep_tile` over the full ``(B, W)`` tile: the
reference's ``net_sweep_ref``.  ``frame0`` / ``total_frames`` place the call
inside a larger logical launch; ``decide=True`` appends the argmax epilogue.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitops
from repro_torch.kernels.net_sweep.common import SweepPlan, sweep_tile


def net_sweep_ref(
    kd0: int,
    kd1: int,
    ev: torch.Tensor,
    plan: SweepPlan,
    n_bits: int,
    frame0: int = 0,
    total_frames: int | None = None,
    decide: bool = False,
):
    """ev (B, n_ev) int32 -> (numer (B, n_value_slots) i32, denom (B,) i32
    [, decisions (B, n_q) i32])."""
    b = ev.shape[0]
    w = bitops.n_words(n_bits)
    total = b if total_frames is None else total_frames
    return sweep_tile(plan, kd0, kd1, ev, frame0, 0, b, w, w, total,
                      decide=decide)
