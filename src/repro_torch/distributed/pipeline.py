"""GPipe-style pipeline parallelism over a mesh axis (default: `pod`).

Layer stages are spread over the axis, one per rank along it; microbatches
stream through, and after each tick every stage passes its activation to the
next (``i -> i+1 mod S``), the reference's ``ppermute``, as an
``all_to_all_single`` over the axis.  The bubble is the
standard (S-1)/(M+S-1) GPipe overhead.  Forward only, as in the reference.

Every rank passes the whole stacked params and the whole microbatched input
(the reference's ``shard_map`` takes the params sharded over the axis and the
input replicated); each keeps its stage's slice.  The last stage commits the
outputs, and a sum over the axis gives them to every rank.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def _stage_slice(tree, s: int):
    if isinstance(tree, dict):
        return {k: _stage_slice(v, s) for k, v in tree.items()}
    return tree[s]


def _shift(y: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The reference's ``ppermute(y, axis, [(i, (i + 1) % S)])``: this rank's
    ``y`` goes to the next stage along ``axis``; returns the previous stage's.
    One ``all_to_all_single`` over the axis's group, every split empty but
    the one to the next stage and the one from the previous (gloo carries no
    send/recv of CUDA tensors).  Stages are found by mesh coordinate and
    global rank, so no group order is assumed."""
    group = mesh.get_group(axis)
    dim = mesh.mesh_dim_names.index(axis)
    n = mesh.shape[dim]
    coord = list(mesh.get_coordinate())

    def group_rank(stage):
        at = list(coord)
        at[dim] = stage % n
        return dist.get_group_rank(group, int(mesh.mesh[tuple(at)]))

    nxt, prev = group_rank(coord[dim] + 1), group_rank(coord[dim] - 1)
    flat = y.contiguous().reshape(-1)
    out = torch.empty_like(flat)
    dist.all_to_all_single(out, flat,
                           output_split_sizes=[flat.numel() if j == prev else 0 for j in range(n)],
                           input_split_sizes=[flat.numel() if j == nxt else 0 for j in range(n)],
                           group=group)
    return out.reshape(y.shape)


def pipeline_forward(
    stage_fn: Callable,
    stage_params,
    x: torch.Tensor,
    mesh,
    *,
    axis: str = "pod",
    microbatches: int | None = None,
):
    """Run ``stage_fn`` stages spread over ``axis`` as a GPipe pipeline.

    stage_params: dict of tensors stacked on the leading axis with size =
                  the axis's size (one slice per stage).
    x:            (M, B, ...) microbatched input; every stage must preserve
                  the activation shape (standard homogeneous-stage pipeline).
    Returns (M, B, ...) outputs of the final stage, on every rank.
    """
    n_stages = mesh.shape[mesh.mesh_dim_names.index(axis)]
    m = x.shape[0]
    assert m >= 1
    stage = mesh.get_local_rank(axis)
    params_stage = _stage_slice(stage_params, stage)
    buf = torch.zeros_like(x[0])                   # activation in flight
    outs = torch.zeros_like(x)
    for t in range(m + n_stages - 1):
        # stage 0 ingests microbatch t (when in range)
        x_in = x[min(t, m - 1)] if stage == 0 and t < m else buf
        y = stage_fn(params_stage, x_in)
        # last stage commits microbatch (t - n_stages + 1)
        if stage == n_stages - 1 and t >= n_stages - 1:
            outs[t - n_stages + 1] = y
        buf = _shift(y, mesh, axis)
    # only the last stage holds committed outputs; the sum broadcasts them
    outs = outs if stage == n_stages - 1 else torch.zeros_like(outs)
    dist.all_reduce(outs, group=mesh.get_group(axis))
    return outs


def reference_forward(stage_fn, stage_params, x):
    """Unpipelined oracle: apply all stages sequentially to each microbatch."""
    first = stage_params
    while isinstance(first, dict):
        first = next(iter(first.values()))
    n_stages = first.shape[0]
    outs = []
    for xm in x:
        for s in range(n_stages):
            xm = stage_fn(_stage_slice(stage_params, s), xm)
        outs.append(xm)
    return torch.stack(outs)
