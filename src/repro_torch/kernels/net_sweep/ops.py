"""Public wrapper of the fused whole-network sweep.

``net_sweep`` runs an entire compiled Bayesian network -- every node's
threshold-gather sample, the evidence AND and the popcounts -- in one launch.
The tensor's device decides what runs: on a CUDA tensor the hand-written
kernel (``kernel.net_sweep_cuda``) launches or raises; on a CPU tensor the
plain torch version (``ref.net_sweep_ref``) runs.  There is no fallback
between the two.
"""

from __future__ import annotations

import torch

from repro_torch.core import rng
from repro_torch.kernels.net_sweep.common import SweepPlan
from repro_torch.kernels.net_sweep.kernel import net_sweep_cuda
from repro_torch.kernels.net_sweep.ref import net_sweep_ref


def net_sweep(
    key,
    ev_frames: torch.Tensor,
    *,
    plan: SweepPlan,
    n_bits: int = 4096,
    frame0: int = 0,
    total_frames: int | None = None,
    decide: bool = False,
):
    """Run the fused sweep: per-frame independent joint samples, conditioned.

    ``key``: ``(2,)`` uint32 key data (``repro_torch.core.prng``).
    ev_frames: (B, n_ev) int32 evidence values, columns in ``plan.evidence``
    order.  Returns ``(numer (B, n_value_slots) int32, denom (B,) int32)``
    -- one popcount per query value (queries in plan order, values
    ``1 .. card-1``; the value-0 count is ``denom`` minus the query's slots)
    and the accepted-bit count per frame -- plus ``(B, n_q) int32``
    decisions with ``decide=True``.  ``frame0`` / ``total_frames`` let a
    slice of a larger batch draw that batch's entropy.
    """
    if n_bits % 32:
        raise ValueError("n_bits must be a multiple of 32 (packed words)")
    if ev_frames.dim() != 2 or ev_frames.shape[1] != len(plan.evidence):
        raise ValueError(
            f"evidence frames must be (B, {len(plan.evidence)}), "
            f"got {tuple(ev_frames.shape)}"
        )
    ev = ev_frames.to(torch.int32)
    kd0, kd1 = rng.seed_words(key)
    kwargs = dict(plan=plan, n_bits=n_bits, frame0=frame0,
                  total_frames=total_frames, decide=decide)
    if ev.device.type == "cuda":
        return net_sweep_cuda(kd0, kd1, ev, **kwargs)
    if ev.device.type == "cpu":
        return net_sweep_ref(kd0, kd1, ev, **kwargs)
    raise ValueError(f"net_sweep runs on 'cuda' or 'cpu' tensors, got {ev.device}")
