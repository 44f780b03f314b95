"""Ambient mesh context: lets model code apply sharding constraints and the
expert-parallel path without threading the mesh through every call.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the reference's
axis names (``frames``; ``data``, ``model``; ``pod``) over the default process
group, one rank per device (``torchrun``, or ``torch.multiprocessing.spawn``).
Every rank runs the same program on the same global inputs, as the
reference's single controller does; a sharded entry point returns the global
result on every rank.

Launchers do ``with mesh_context(mesh): api.loss(...)``.  Inside, a plain
tensor that meets a DTensor counts as replicated on every rank (DTensor's
``implicit_replication``): every rank computes it alike.  When no mesh is
active every helper is a no-op, so single-device code runs the same path.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Tuple

import torch

from repro_torch.distributed import sharding as _sharding

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


def current_mesh() -> Optional[object]:
    """The ambient ``DeviceMesh``, or ``None``."""
    return _MESH.get()


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` the ambient mesh inside the ``with`` block, with
    DTensor's implicit replication on (a thread's own setting, restored on
    exit: ``implicit_replication()`` would turn it off inside an enclosing
    block)."""
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    token = _MESH.set(mesh)
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield mesh
    finally:
        dispatcher._allow_implicit_replication = before
        _MESH.reset(token)


def world_size() -> int:
    """Ranks of the started default process group (1 when none is started)."""
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def frame_mesh(devices: int | None = None, *, device="cuda"):
    """1-D ``DeviceMesh`` over the started world, axis ``"frames"``.

    The frame axis is the embarrassingly parallel batch dimension of the
    bayesnet sweep (``compile_network(devices=...)`` shards over it).  The
    reference takes the first ``devices`` local devices of one process; here
    each device is a rank of the default process group, so ``devices`` must
    be the world's size (``None`` takes it).  With no group started there is
    one device and nothing to shard: ``devices`` of ``None`` or 1 give
    ``None``.  ``device`` names the mesh's device type (the ranks' device).
    """
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels import backend

    n_world = world_size()
    n = n_world if devices is None else int(devices)
    if not (torch.distributed.is_available() and torch.distributed.is_initialized()):
        if n == 1:
            return None
        raise ValueError(f"devices={devices} needs a started process group of {n} ranks; "
                         f"none is started (one device)")
    if n != n_world:
        raise ValueError(f"devices={devices} differs from the started world's "
                         f"{n_world} ranks")
    dev = backend.resolve_device(device)
    return init_device_mesh(dev.type, (n,), mesh_dim_names=("frames",))


def heads_axis(n_heads: int) -> Optional[str]:
    """``"model"`` where the ambient mesh's ``model`` axis has more than one
    shard and divides ``n_heads`` (the heads then split over it, whole heads
    to a rank), else ``None`` (replicated)."""
    mesh = current_mesh()
    m = 1 if mesh is None else _sharding.mesh_sizes(mesh).get("model", 1)
    return "model" if m > 1 and n_heads % m == 0 else None


def batch_axes() -> Tuple[str, ...]:
    mesh = current_mesh()
    if mesh is None:
        return ()
    return _sharding.batch_axes(mesh)


def _resolve_spec(shape, spec, mesh) -> tuple:
    """The reference's rules for a constraint's spec: ``"batch"`` expands to
    the batch axes; axes unknown to the mesh or already used by an earlier dim
    are dropped; a dim its axes' product does not divide is replicated."""
    sizes = _sharding.mesh_sizes(mesh)
    resolved = []
    used: set = set()
    for dim, s in enumerate(spec):
        if s == "batch":
            ax = _sharding.batch_axes(mesh)
            s = ax if len(ax) > 1 else (ax[0] if ax else None)
        if s is None:
            resolved.append(None)
            continue
        axes = s if isinstance(s, tuple) else (s,)
        axes = tuple(a for a in axes if a in sizes and a not in used)
        if not axes:
            resolved.append(None)
            continue
        if dim < len(shape) and shape[dim] % math.prod(sizes[a] for a in axes) == 0:
            used.update(axes)
            resolved.append(axes if len(axes) > 1 else axes[0])
        else:
            resolved.append(None)
    return tuple(resolved)


def constrain(x, *spec):
    """Pin ``x``'s layout under the ambient mesh (the reference's
    ``with_sharding_constraint``): a DTensor is redistributed to the resolved
    spec (:func:`_resolve_spec`), every axis it does not name replicated.  A
    plain tensor, or any tensor with no mesh, is returned as it is."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    place = _sharding.placements(_resolve_spec(tuple(x.shape), spec, mesh), mesh)
    return x if tuple(x.placements) == place else x.redistribute(mesh, place)


def embed(table, tokens):
    """``table[tokens]``, an embedding lookup, under the ambient mesh.

    A DTensor table is gathered whole and each rank looks up its own tokens'
    rows on local tensors; the rows come back placed as the tokens are.  Its
    gradient is each rank's partial sum over its tokens, summed over the mesh
    dims the tokens are split on (the others hold the same tokens) and
    scattered back to the table's placement.  DTensor's own rules for the
    lookup fail on this layout: torch 2.11's for ``index_put`` (the lookup's
    backward) and for tokens split over two mesh dims, 2.13's for the
    partial rows of a vocabulary-sharded ``F.embedding``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(table, DTensor):
        return table[tokens]
    split = tokens.placements if isinstance(tokens, DTensor) else ()
    grads = [Partial() if p.is_shard() else Replicate() for p in split] \
        or [Replicate()] * table.device_mesh.ndim
    whole = table.full_tensor(grad_placements=grads)
    (local,), placed = local_blocks(tokens)
    return placed(whole[local])


def local_blocks(*tensors):
    """``(blocks, wrap)``: each DTensor's block on this rank (all placed
    alike) and ``wrap``, which makes a result of the blocks' layout a DTensor
    placed as the first was; plain tensors and ``wrap`` the identity when no
    DTensor is given.  For code that runs per rank on its own rows."""
    from torch.distributed.tensor import DTensor

    first = tensors[0]
    if not isinstance(first, DTensor):
        return tensors, lambda out: out
    if any(tuple(t.placements) != tuple(first.placements) for t in tensors):
        raise ValueError("local_blocks: the tensors are placed differently")
    mesh, place = first.device_mesh, first.placements
    return tuple(t.to_local() for t in tensors), \
        (lambda out: DTensor.from_local(out, mesh, place, run_check=False))


def param_block(p, rows, *spec):
    """This rank's block of the parameter ``p`` placed by ``spec``, as a plain
    tensor, for code that runs per rank on the blocks of ``rows`` (a DTensor
    whose dim 0 holds the rows; :func:`local_blocks`): its gradient is each
    rank's sum over its own rows, so it is summed over the mesh dims that
    split the rows.  ``p`` as it is where it is a plain tensor."""
    from torch.distributed.tensor import DTensor, Partial

    if not isinstance(p, DTensor):
        return p
    p = constrain(p, *spec)
    grads = []
    for r, q in zip(rows.placements, p.placements):
        if r.is_shard(0) and not q.is_replicate():
            raise ValueError(f"param_block: the parameter is split ({q}) over a mesh dim "
                             f"that splits the rows")
        grads.append(Partial() if r.is_shard(0) else q)
    return p.to_local(grad_placements=grads)


def _block_index(mesh, place, dim: int) -> int:
    """Index of this rank's block of tensor dim ``dim`` under ``place``: the
    mesh dims that shard it, in mesh order, major first (0 where none does)."""
    idx = 0
    for i, p in enumerate(place):
        if p.is_shard(dim):
            idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx


def _placed(t, mesh, place):
    """``t`` redistributed to ``place`` (a plain ``t`` counts as replicated)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return t if tuple(t.placements) == tuple(place) else t.redistribute(mesh, place)


def like(t, ref):
    """``t`` placed as the DTensor ``ref`` is; ``t`` as it is where ``ref``
    is a plain tensor."""
    from torch.distributed.tensor import DTensor

    return _placed(t, ref.device_mesh, ref.placements) if isinstance(ref, DTensor) else t


def new_state(build, device):
    """The empty decode state ``build(device)``.  Under the ambient mesh it
    is built on ``meta`` and placed by ``sharding.place_state``: each rank
    builds its own block of each leaf, never the global cache."""
    mesh = current_mesh()
    if mesh is None:
        return build(device)
    return _sharding.place_state(build("meta"), mesh, device=device)


def write_slots(buf, new, start: int, dim: int):
    """A copy of the DTensor ``buf`` with ``new`` written at ``start`` along
    ``dim``, placed as ``buf`` (``layers._write_slots`` on a placed cache:
    DTensor refuses ``narrow().copy_()``).  ``new`` is brought to ``buf``'s
    placements with ``dim`` whole; each rank writes the part of it that falls
    in its own block of ``buf``."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh, place = buf.device_mesh, tuple(buf.placements)
    part = _placed(new, mesh, [Replicate() if p.is_shard(dim) else p for p in place]).to_local()
    local = buf.to_local()
    lo = _block_index(mesh, place, dim) * local.shape[dim]
    a, b = max(start, lo), min(start + part.shape[dim], lo + local.shape[dim])
    out = local.clone()
    if a < b:
        out.narrow(dim, a - lo, b - a).copy_(part.narrow(dim, a - start, b - a))
    return DTensor.from_local(out, mesh, place, run_check=False)


def attention_blocks(q, k, v):
    """``((q, k, v), wrap)``: the blocks of q (B, S, H, hd) and k, v (B, T,
    KV, hd) that this rank attends, as plain tensors, and ``wrap``, which
    places an output of q's local layout as q is.

    Each rank takes its own rows.  Where the ambient mesh's ``model`` axis
    divides H, it also takes its own query heads, and only the KV heads those
    use: its block of k and v where the axis divides KV, else their slice of
    the gathered k and v (repeated to its query heads only where the heads'
    groups do not fall evenly on it).  Elsewhere every rank attends every
    head.  No score einsum runs on DTensors: torch 2.11 refuses it with the
    batch and the heads both sharded."""
    from torch.distributed.tensor import DTensor

    q = constrain(q, "batch", None, heads_axis(q.shape[2]), None)
    if not (isinstance(q, DTensor) and any(p.is_shard(2) for p in q.placements)):
        return local_blocks(*(constrain(t, "batch", None, None, None) for t in (q, k, v)))
    h, kvh = q.shape[2], k.shape[2]
    k, v = (constrain(t, "batch", None, heads_axis(kvh), None) for t in (k, v))
    mesh, place = q.device_mesh, q.placements
    ql = q.to_local()
    kl, vl = (t.to_local() if isinstance(t, DTensor) else t for t in (k, v))
    if not (isinstance(k, DTensor) and any(p.is_shard(2) for p in k.placements)):
        h_loc, group = ql.shape[2], h // kvh
        q0 = _block_index(mesh, place, 2) * h_loc
        idx = [(q0 + i) // group for i in range(h_loc)]
        n = idx[-1] - idx[0] + 1
        if h_loc % n == 0 and idx == [idx[0] + i // (h_loc // n) for i in range(h_loc)]:
            kl, vl = (t[:, :, idx[0]:idx[0] + n] for t in (kl, vl))
        else:
            sel = torch.tensor(idx, device=kl.device)
            kl, vl = (t.index_select(2, sel) for t in (kl, vl))
    return (ql, kl, vl), (lambda out: DTensor.from_local(out, mesh, place, run_check=False))


def vocab_sharded(logits) -> bool:
    """Whether ``logits`` is a DTensor whose last (vocabulary) dim is split
    over exactly one mesh dim of more than one shard."""
    from torch.distributed.tensor import DTensor

    if not isinstance(logits, DTensor):
        return False
    dims = [i for i, p in enumerate(logits.placements) if p.is_shard(logits.ndim - 1)]
    return len(dims) == 1 and logits.device_mesh.size(dims[0]) > 1


class _VocabNLL(torch.autograd.Function):
    """Per-row ``logsumexp(x) - x[label]`` of logits whose vocabulary is split
    over ``group``, on this rank's block ``local`` (vocabulary entries from
    ``lo``): the row max, the sum of exponentials and the label's logit
    (taken on the rank whose block holds it) are all-reduced over the group."""

    @staticmethod
    def forward(ctx, local, labels, lo, group):
        dist = torch.distributed
        peak = local.amax(-1)
        dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=group)
        sumexp = (local - peak[..., None]).exp_().sum(-1)
        dist.all_reduce(sumexp, group=group)
        mine = (labels >= lo) & (labels < lo + local.shape[-1])
        idx = torch.where(mine, labels - lo, 0).long()[..., None]
        picked = torch.where(mine, torch.gather(local, -1, idx)[..., 0] - peak, 0.0)
        dist.all_reduce(picked, group=group)
        ctx.save_for_backward(local, peak, sumexp, idx, mine)
        return torch.log(sumexp) - picked

    @staticmethod
    def backward(ctx, grad):
        # softmax - onehot, on the local block only
        local, peak, sumexp, idx, mine = ctx.saved_tensors
        g = (local - peak[..., None]).exp_().mul_((grad / sumexp)[..., None])
        g.scatter_add_(-1, idx, -torch.where(mine, grad, 0.0)[..., None])
        return g, None, None, None


def vocab_nll(logits, labels):
    """``-log_softmax(logits)[label]`` per row, of float logits whose
    vocabulary is split over one mesh dim (:func:`vocab_sharded`), on each
    rank's own block: no rank holds a row's whole vocabulary, in the forward
    or the backward.  The reductions are c10d all-reduces over that mesh dim
    (three, of one value per row).  Returns a DTensor placed as the logits
    with the vocabulary dim dropped; ``labels`` are brought to that
    placement."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh, place, vdim = logits.device_mesh, tuple(logits.placements), logits.ndim - 1
    (axis,) = [i for i, p in enumerate(place) if p.is_shard(vdim)]
    rows = tuple(Replicate() if p.is_shard(vdim) else p for p in place)
    local = logits.to_local()
    nll = _VocabNLL.apply(local, _placed(labels, mesh, rows).to_local(),
                          _block_index(mesh, place, vdim) * local.shape[-1],
                          mesh.get_group(axis))
    return DTensor.from_local(nll, mesh, rows, run_check=False)


def whole(t):
    """A DTensor's global value as a plain tensor on every rank (``None`` and
    plain tensors as they are)."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def pin(x):
    """``x`` as it is, through a node whose backward brings the gradient to
    ``x``'s own layout (a DTensor's ``redistribute`` to its placements).  An
    attention output flattened from its heads takes its gradient from the
    out-projection sharded over the features; unflattened back into heads
    whose count the shards do not divide, DTensor refuses it."""
    from torch.distributed.tensor import DTensor

    return x.redistribute(x.device_mesh, x.placements) if isinstance(x, DTensor) else x


def recomputed(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (recomputed in the
    backward), the recomputation under the ambient mesh: a CUDA backward runs
    on autograd's device thread, which takes the caller's thread-local state
    (grad mode, dispatch modes, DTensor's implicit replication) but not its
    context variables, so the mesh would be unset there and every
    ``constrain`` skipped."""
    from torch.utils import checkpoint

    mesh = current_mesh()

    def body(*a):
        again = mesh is not None and current_mesh() is None
        with mesh_context(mesh) if again else contextlib.nullcontext():
            return fn(*a)

    return checkpoint.checkpoint(body, *args, use_reentrant=False)
