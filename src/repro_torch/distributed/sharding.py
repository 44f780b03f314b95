"""Mesh-axis sharding rules (FSDP over `data`, TP/EP over `model`, DP over `pod`).

The reference's rules, name for name.  A spec is a tuple with one entry per
tensor dim: ``None`` (replicated), a mesh axis name, or a tuple of names (the
dim split over those axes, major to minor).  :func:`placements` turns one into
DTensor placements for a ``DeviceMesh``.

Param specs are derived from leaf names: each rule names the preferred mesh
axis for the trailing dimensions; any leading (stack/expert) dims fall back per
rule.  A preferred axis is only applied when the dim is divisible by the mesh
axis size (e.g. 10 attention heads on a 16-way model axis fall back to
replicated -- the projection then shards its contracting dim instead via the
`data` FSDP axis).

The reference stacks a ``blocks`` leaf over its repetitions (and the enc-dec
stacks over layers); the port holds one tensor per repetition
(``models/convert.py``).  So :func:`param_specs` groups the port's leaves by
reference leaf, applies the rule to the stacked shape, and gives each
repetition the stacked spec without its leading dim.  Where the reference puts
an axis on that leading dim (a shared expert's leaves, whose "expert" dim is
the stack), the port's repetitions are replicated over it: each holds a whole
layer.

Spec computation needs no devices: a mesh here is anything with
``mesh_dim_names`` and ``shape`` -- a ``DeviceMesh`` or a :class:`MeshShape`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

# leaf name -> spec template for the trailing dims (applied right-aligned).
# "F" = fsdp axis ('data'), "T" = tensor axis ('model'), None = replicated.
_NAME_RULES = {
    "embed": ("T", "F"),          # (V, D)
    "unembed": ("F", "T"),        # (D, V)
    "wq": ("F", "T"),
    "wk": ("F", "T"),
    "wv": ("F", "T"),
    "wo": ("T", "F"),
    "bq": ("T",),
    "bk": ("T",),
    "bv": ("T",),
    "wi": ("F", "T"),
    "wg": ("F", "T"),
    # MLA
    "w_dq": ("F", "T"),
    "w_uq": ("T", None),
    "w_dkv": ("F", None),
    "w_ukv": (None, "T"),
    # RG-LRU / xLSTM
    "wx": ("F", "T"),
    "wy": ("F", "T"),
    "conv": (None, "T"),
    "w_input_gate": (None, "T"),
    "w_rec_gate": (None, "T"),
    "lambda_raw": ("T",),
    "w_up": ("F", "T"),
    "w_gate": ("F", "T"),
    "w_down": ("T", "F"),
    "w_i": (None, None),
    "w_f": (None, None),
    "w_z": ("F", "T"),
    "w_o": ("F", "T"),
    # MoE (trailing dims; expert dim handled by the leading-dim rule below)
    "router": ("F", None),
    "proj": ("F", "T"),
}

# leaves whose leading (first) dim is the expert axis -> shard over model (EP)
_EXPERT_LEAVES = {"wi", "wg", "wo"}

# Sharding policy knobs (set by launchers/variants before building shardings).
#   fsdp2d: drop TP; FSDP params over BOTH (data, model) axes and shard the
#   batch over both -- pure ZeRO-3.
POLICY = {"fsdp2d": False}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices (for spec computation)."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def mesh_sizes(mesh) -> dict:
    """Axis name -> size."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def axis_name(mesh, role: str):
    names = mesh.mesh_dim_names
    if POLICY["fsdp2d"]:
        if role == "F":
            return ("data", "model") if "model" in names else "data"
        return None   # no TP axis in pure-FSDP mode
    if role == "F":
        return "data" if "data" in names else None
    if role == "T":
        return "model" if "model" in names else None
    return None


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the global batch is sharded over.

    A mesh carrying a ``"frames"`` axis (``context.frame_mesh``, the bayesnet
    sweep's frame-parallel fabric) batches over exactly that axis; the LM
    meshes batch over ``(pod,) data``.
    """
    names = mesh.mesh_dim_names
    if "frames" in names:
        return ("frames",)
    if POLICY["fsdp2d"]:
        return tuple(a for a in ("pod", "data", "model") if a in names)
    return ("pod", "data") if "pod" in names else ("data",)


def _ax_size(sizes, ax) -> int:
    return math.prod(sizes[a] for a in ax) if isinstance(ax, tuple) else sizes[ax]


def spec_for_leaf(path: Tuple[str, ...], shape: Tuple[int, ...], mesh) -> tuple:
    """The spec of one leaf of the reference's layout: ``path`` its dict keys
    (``("blocks", "attn", "wq")``; indices left out), ``shape`` its shape with
    the stacked leading dim of a ``blocks`` / ``enc_blocks`` / ``dec_blocks``
    leaf."""
    name = path[-1] if path else ""
    rule = _NAME_RULES.get(name)
    ndim = len(shape)
    spec = [None] * ndim
    sizes = mesh_sizes(mesh)
    if rule is not None:
        # right-align the rule on the trailing dims
        for i, role in enumerate(rule):
            dim = ndim - len(rule) + i
            if dim < 0 or role is None:
                continue
            ax = axis_name(mesh, role)
            if ax is not None and shape[dim] % _ax_size(sizes, ax) == 0:
                spec[dim] = ax
        # expert leading dim (stacked (L,) E, D, F leaves): the expert dim is
        # the dim right before the rule's trailing dims
        if name in _EXPERT_LEAVES and "moe" in path and ndim >= 3:
            edim = ndim - len(rule) - 1
            ax = axis_name(mesh, "T")
            if edim >= 0 and ax is not None and shape[edim] % sizes[ax] == 0:
                # EP owns the model axis for expert weights: clear TP on F dim
                for i in range(ndim):
                    if spec[i] == ax:
                        spec[i] = None
                spec[edim] = ax
                # FSDP the (now TP-free) contracting dim if divisible and free
                fax = axis_name(mesh, "F")
                if fax is not None and fax not in spec and ndim - 2 >= 0 \
                        and spec[ndim - 2] is None \
                        and shape[ndim - 2] % _ax_size(sizes, fax) == 0:
                    spec[ndim - 2] = fax
    return tuple(spec)


def param_specs(params, mesh) -> dict:
    """State-dict key -> spec, for every parameter of ``params`` (a port model,
    or a dict of tensors keyed like its state dict; shapes only, so the
    ``meta`` device does)."""
    from repro_torch.models import convert

    shapes = dict(params.named_parameters()) if hasattr(params, "named_parameters") \
        else dict(params)
    shapes = {k: tuple(v.shape) for k, v in shapes.items()}
    out = {}
    for _, members in convert.reference_leaves(shapes):
        path, _ = convert.reference_path(members[0][1])
        keys = tuple(p for p in path if isinstance(p, str))
        shape = shapes[members[0][1]]
        stacked = members[0][0] is not None
        spec = spec_for_leaf(keys, ((len(members),) if stacked else ()) + shape, mesh)
        for _, key in members:
            out[key] = spec[1:] if stacked else spec
    return out


def placements(spec: tuple, mesh) -> tuple:
    """A spec -> DTensor placements on ``mesh`` (one per mesh dim): ``Shard(d)``
    on each mesh axis that tensor dim ``d`` carries, ``Replicate()`` on the
    others.  A dim split over several axes lists them major to minor, the
    layout JAX gives ``P(("data", "model"))``."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.mesh_dim_names)
    for dim, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        at = [mesh.mesh_dim_names.index(a) for a in axes if a is not None]
        if at != sorted(at):
            # DTensor splits a dim over mesh dims in mesh order, major first
            raise ValueError(f"dim {dim} of {spec}: axes out of the mesh's order "
                             f"{mesh.mesh_dim_names}")
        for ax in axes:
            if ax is not None:
                out[mesh.mesh_dim_names.index(ax)] = Shard(dim)
    return tuple(out)


def param_shardings(params, mesh) -> dict:
    """State-dict key -> DTensor placements on ``mesh``."""
    return {k: placements(s, mesh) for k, s in param_specs(params, mesh).items()}


def shard(t, mesh, place):
    """The DTensor of ``place`` whose global value is ``t``, which every rank
    holds whole (the single controller's view): each rank keeps its block, and
    nothing is sent (``distribute_tensor`` would scatter from one rank, which
    gloo cannot do for CUDA tensors)."""
    from torch.distributed.tensor import DTensor, Replicate

    whole = DTensor.from_local(t, mesh, [Replicate()] * len(place), run_check=False)
    return whole.redistribute(mesh, place)


def distribute_params(params, mesh):
    """Place every parameter of the model ``params`` as a DTensor by
    :func:`param_shardings`, in place; returns ``params``.  Every rank passes
    the same full values."""
    from torch import nn

    for key, place in param_shardings(params, mesh).items():
        owner, _, leaf = key.rpartition(".")
        mod = params.get_submodule(owner) if owner else params
        p = getattr(mod, leaf)
        mod.register_parameter(leaf, nn.Parameter(shard(p.detach(), mesh, place),
                                                  requires_grad=p.requires_grad))
    return params


def batch_sharding(mesh) -> tuple:
    """Inputs: tokens/labels (B, S) sharded over batch axes (placements)."""
    ax = batch_axes(mesh)
    return placements((ax if len(ax) > 1 else ax[0], None), mesh)


# offset of the batch dim counted from the END, per leaf name (robust to an
# optional leading stacked-layer axis): k/v are (..., B, T, KV, hd) etc.
_BDIM_FROM_END = {
    "k": 4, "v": 4, "k_rope": 4, "latent": 3, "C": 4, "n": 3, "m": 2,
    "h": 2, "conv": 3, "c": 2,
}


def _state_leaf_spec(name: str, shape, sizes, baxes, bsize, tsize) -> tuple:
    ndim = len(shape)
    if name == "pos":
        return (None,) * ndim
    spec = [None] * ndim
    bdim = ndim - _BDIM_FROM_END.get(name, ndim)
    if 0 <= bdim < ndim and shape[bdim] % bsize == 0 and bsize > 1:
        spec[bdim] = baxes if len(baxes) > 1 else baxes[0]
    # kv caches: (..., T, KV, hd) or latents (..., T, R)
    if name in ("k", "v", "k_rope"):
        kv_dim, seq_dim = ndim - 2, ndim - 3
        if shape[kv_dim] % tsize == 0 and tsize > 1:
            spec[kv_dim] = "model"
        elif shape[seq_dim] % tsize == 0 and tsize > 1:
            spec[seq_dim] = "model"   # sequence-shard the cache
    elif name == "latent":
        seq_dim = ndim - 2
        if shape[seq_dim] % tsize == 0 and tsize > 1:
            spec[seq_dim] = "model"
    elif name == "C":  # mLSTM matrix memory (..., NH, DK, DV)
        if shape[-1] % tsize == 0 and tsize > 1:
            spec[-1] = "model"
    elif name in ("h", "n", "conv", "c", "m"):
        if shape[-1] % tsize == 0 and tsize > 1:
            spec[-1] = "model"
    return tuple(spec)


def state_specs_for_cache(state, mesh):
    """Decode-state (KV cache / recurrent state) specs, in ``state``'s own
    structure (dicts, lists, tuples; ``None`` stays ``None``).

    Batch dim is sharded over the batch axes.  KV-head / feature dims shard
    over `model` when divisible; otherwise, for batch=1 long-context, the
    sequence axis of k/v shards over `model` (cache too big to replicate).
    """
    sizes = mesh_sizes(mesh)
    baxes = batch_axes(mesh)
    bsize = math.prod(sizes[a] for a in baxes)
    tsize = sizes.get("model", 1)

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        if node is None:
            return None
        return _state_leaf_spec(name, tuple(node.shape), sizes, baxes, bsize, tsize)

    return walk(state, "")


# each decode-state leaf's initial value (``layers.init_kv_cache``,
# ``mla.mla_init_cache``, ``rglru``'s and ``xlstm``'s ``*_init_state``); 0 for
# every leaf not named here
_STATE_FILL = {"pos": -1, "m": -1e30}


def place_state(state, mesh, *, device):
    """The empty decode state ``state`` placed on ``mesh`` by
    :func:`state_specs_for_cache`: each leaf a DTensor whose block on this
    rank is built at its local shape on ``device``, filled with the leaf's
    initial value.  ``state`` gives only shapes and dtypes (built on
    ``meta``): no tensor of the global size is allocated."""
    import torch
    from torch.distributed.tensor import DTensor

    sizes = mesh_sizes(mesh)

    def build(leaf, spec, name):
        shape = list(leaf.shape)
        for dim, entry in enumerate(spec):
            if entry is not None:
                shape[dim] //= _ax_size(sizes, entry)
        local = torch.full(shape, _STATE_FILL.get(name, 0), dtype=leaf.dtype, device=device)
        return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False)

    def walk(node, spec, name):
        if isinstance(node, dict):
            return {k: walk(v, spec[k], k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, s, name) for v, s in zip(node, spec))
        return None if node is None else build(node, spec, name)

    return walk(state, state_specs_for_cache(state, mesh), "")
