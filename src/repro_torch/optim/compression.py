"""Stochastic-number gradient compression with error feedback.

Beyond-paper extension that reuses the paper's representation: a gradient
tensor is encoded as a *stochastic fixed-point number* -- int8 with Bernoulli
(unbiased stochastic) rounding, exactly an SNE quantisation of p =
frac(g/scale) -- before the cross-pod all-reduce, cutting the collective
roofline term by 4x (bf16 -> int8) at zero bias.  Residual quantisation error
is fed back into the next step (error feedback), which restores convergence
to the uncompressed path.

The reference encodes per leaf of its params tree, and a ``blocks`` leaf
there is stacked over the repetitions (an MoE leaf also carries its expert
axis).  The port's gradients are a dict by parameter name, one tensor per
repetition, so :func:`compress` groups them by reference leaf
(``convert.reference_leaves``): one key per leaf, from ``split(key,
n_leaves)`` in the reference's flatten order; one scale per leaf, ``max|g|``
over all its repetitions; one uniform draw over the stacked shape, sliced
per repetition.  The int8 values, scales and residuals are then the
reference's, bit for bit.  The draw runs on the host (``prng.uniform``) for
CPU tensors and on the card (``prng.device_uniform``) for CUDA ones.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.distributed.context import MULTI_DEVICE_TODO
from repro_torch.models import convert

INT8_MAX = 127.0


def _uniform(key, shape, device) -> torch.Tensor:
    if device.type == "cuda":
        return prng.device_uniform(key, shape, device=device)
    return torch.from_numpy(prng.uniform(key, shape))


def compress(key, grads: Dict[str, torch.Tensor],
             residual: Optional[Dict[str, torch.Tensor]] = None):
    """Encode grads (+carry residual) as (int8 dict, scales dict, new residual
    dict), each keyed like ``grads``; a stacked leaf's repetitions share one
    scale."""
    leaves = convert.reference_leaves(grads)
    keys = prng.split(key, len(leaves))
    qs, scales, new_res = {}, {}, {}
    for (_, members), k in zip(leaves, keys):
        gs = []
        for _, name in members:
            g = grads[name].to(torch.float32)
            if residual is not None:
                g = g + residual[name]
            gs.append(g)
        dev = gs[0].device
        amax = torch.stack([torch.max(torch.abs(g)) for g in gs]).max()
        scale = torch.maximum(amax, torch.tensor(np.float32(1e-12), device=dev)) \
            / torch.tensor(np.float32(INT8_MAX), device=dev)
        stacked = members[0][0] is not None
        u = _uniform(k, ((len(gs),) if stacked else ()) + tuple(gs[0].shape), dev)
        for i, ((_, name), g) in enumerate(zip(members, gs)):
            x = g / scale
            lo = torch.floor(x)
            frac = x - lo                       # in [0,1): the SNE probability
            up = (u[i] if stacked else u) < frac  # Bernoulli(p) bit
            q = torch.clamp(lo + up.to(torch.float32), -INT8_MAX, INT8_MAX)
            qs[name] = q.to(torch.int8)
            scales[name] = scale
            new_res[name] = g - q * scale       # error feedback memory
    return qs, scales, new_res


def decompress(q_tree: Dict[str, torch.Tensor], scales: Dict[str, torch.Tensor]):
    return {k: q.to(torch.float32) * scales[k] for k, q in q_tree.items()}


def compressed_mean(key, grads, residual, axis_name: str):
    """All-reduce-mean of int8-encoded grads over ``axis_name``: needs a
    collective over a mesh, which the port does not have yet."""
    raise NotImplementedError(f"compressed_mean over {axis_name!r}: the all-reduce needs a "
                              f"mesh: {MULTI_DEVICE_TODO}")
