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
from repro_torch.distributed import context as dctx
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


def compressed_mean(key, grads, residual, axis_name: str, mesh=None):
    """All-reduce-mean of int8-encoded grads over the mesh axis ``axis_name``
    (of ``mesh``, or the ambient mesh).  Returns (mean grads fp32, new
    residual).

    The reference's arithmetic inside its ``shard_map``: each rank encodes
    its own gradients with the same ``key``, the int8 codes are summed over
    the axis as float32 (exact for sums this small), and each rank scales
    the sum by ITS OWN scale and divides by the axis size: ``x * sc / n``.
    So the result differs from rank to rank, as in the reference.
    """
    mesh = dctx.current_mesh() if mesh is None else mesh
    if mesh is None or axis_name not in mesh.mesh_dim_names:
        raise ValueError(f"compressed_mean over {axis_name!r} needs a mesh with that axis, "
                         f"got {mesh}")
    q, s, new_res = compress(key, grads, residual)
    group = mesh.get_group(axis_name)
    n = mesh.shape[mesh.mesh_dim_names.index(axis_name)]
    mean = {}
    for name, x in q.items():
        summed = x.to(torch.float32)
        torch.distributed.all_reduce(summed, group=group)
        mean[name] = summed * s[name] / n
    return mean, new_res
