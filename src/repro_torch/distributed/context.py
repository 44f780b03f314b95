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
