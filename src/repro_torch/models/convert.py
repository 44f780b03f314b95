"""Weights carried across from the reference, and back.

The reference's params are a pytree whose ``blocks`` leaves carry a leading
repetition axis (one slice per scanned super-block).  The port's model holds
one module per block, so ``params["blocks"][pos][leaf][rep]`` of the reference
is ``model.blocks[pos][rep].<leaf>`` here, state-dict key
``blocks.<pos>.<rep>.<leaf path>``.  The enc-dec model's ``enc_blocks`` and
``dec_blocks`` carry a leading layer axis: ``enc_blocks.<layer>.<leaf path>``.
Every other leaf keeps its path (``mtp.block.attn.w_dq``); an MoE leaf keeps
its expert axis, ``blocks.<pos>.<rep>.moe.wi`` of shape ``(E, d, d_ff)``.

Leaves travel as numpy arrays: bf16 through ``ml_dtypes.bfloat16`` (what
``np.asarray`` gives of a JAX bf16 array), or as float32 arrays holding bf16
values (a checkpoint's form), which take the dtype of the port's own leaf
when ``cfg`` is given.
"""

from __future__ import annotations

import itertools

import ml_dtypes
import numpy as np
import torch
from torch import nn

from repro_torch.kernels import backend
from repro_torch.models import api, encdec, transformer

_BF16 = np.dtype(ml_dtypes.bfloat16)


def _to_torch(a, dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == _BF16:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    if dtype is not None and t.dtype != dtype:
        cast = t.to(dtype)
        if not torch.equal(cast.to(t.dtype), t):
            raise ValueError(f"a {t.dtype} leaf does not hold {dtype} values")
        t = cast
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16)
    return t.numpy()


def _tree(ref, like, device):
    """A reference dict of leaves -> a dict of tensors (dtypes from ``like``)."""
    out = {}
    for name, value in ref.items():
        sub = None if like is None else like[name]
        if isinstance(value, dict):
            out[name] = _tree(value, sub, device)
        else:
            out[name] = _to_torch(value, None if sub is None else sub.dtype, device)
    return out


_STACKED_LAYERS = ("enc_blocks", "dec_blocks")   # the enc-dec stacks, one slice per layer


def params_from_reference(tree, cfg=None, *, device="cuda"):
    """The reference's ``api.init`` params (numpy leaves) -> a port model on
    ``device`` with the same values: ``blocks`` unstacked per repetition (the
    expert axis of an MoE leaf stays in one tensor), ``enc_blocks`` and
    ``dec_blocks`` per layer, every other tree (``mtp`` among them) as it is.

    With ``cfg``, float32 leaves that the port holds in bf16 are cast (they
    must hold bf16 values exactly; float32 leaves such as the router stay
    float32), and the model knows its config.
    """
    dev = backend.resolve_device(device)
    like = None if cfg is None else api.init(cfg, np.zeros(2, np.uint32), device="meta")

    def sub(*path):
        node = like
        for name in path:
            if node is None:
                return None
            node = node[name]
        return node

    p = {}
    for name, value in tree.items():
        if name == "prefix":
            p[name] = [transformer.ParamTree(_tree(b, sub(name, i), dev))
                       for i, b in enumerate(value)]
        elif name == "blocks":
            p[name] = [nn.ModuleList(
                transformer.ParamTree(_tree(_slice(stacked, r), sub(name, pos, r), dev))
                for r in range(_depth(stacked))) for pos, stacked in enumerate(value)]
        elif name in _STACKED_LAYERS:
            p[name] = [transformer.ParamTree(_tree(_slice(value, r), sub(name, r), dev))
                       for r in range(_depth(value))]
        elif isinstance(value, dict):
            p[name] = _tree(value, sub(name), dev)
        else:
            p[name] = _to_torch(value, None if like is None else like[name].dtype, dev)
    model = encdec.Model if "enc_blocks" in tree else transformer.Model
    return model(p, cfg)


def _depth(stacked) -> int:
    return len(next(iter(_leaves(stacked))))


def _leaves(d):
    for v in d.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _slice(d, r):
    return {k: _slice(v, r) if isinstance(v, dict) else np.asarray(v)[r] for k, v in d.items()}


def _numpy_tree(module) -> dict:
    out = {}
    for name in module.keys():
        v = module[name]
        out[name] = _numpy_tree(v) if isinstance(v, transformer.ParamTree) else _to_numpy(v)
    return out


def _stack(trees):
    first = trees[0]
    return {k: _stack([t[k] for t in trees]) if isinstance(first[k], dict)
            else np.stack([t[k] for t in trees]) for k in first}


def params_to_reference(model) -> dict:
    """The inverse of :func:`params_from_reference`: the reference's stacked
    pytree, as numpy leaves (bf16 as ``ml_dtypes.bfloat16``)."""
    out = {}
    for name in model.keys():
        v = model[name]
        if name == "prefix":
            out[name] = [_numpy_tree(b) for b in v]
        elif name == "blocks":
            out[name] = tuple(_stack([_numpy_tree(b) for b in reps]) for reps in v)
        elif name in _STACKED_LAYERS:
            out[name] = _stack([_numpy_tree(b) for b in v])
        elif isinstance(v, transformer.ParamTree):
            out[name] = _numpy_tree(v)
        else:
            out[name] = _to_numpy(v)
    return out


def state_dict_key(keystr: str, rep: int | None = None) -> str:
    """The port's state-dict key of a reference leaf, from its ``keystr``
    path (``"['blocks'][0]['attn']['wq']"``), with ``rep`` the repetition of
    a stacked ``blocks`` leaf or the layer of an ``enc_blocks`` /
    ``dec_blocks`` leaf."""
    parts = [p.strip("'\"") for p in keystr.strip("[]").split("][")]
    at = 2 if parts[0] == "blocks" else 1 if parts[0] in _STACKED_LAYERS else None
    if at is not None:
        if rep is None:
            raise ValueError(f"{keystr}: a stacked {parts[0]} leaf needs its repetition")
        parts = parts[:at] + [str(rep)] + parts[at:]
    return ".".join(parts)


def reference_path(key: str) -> tuple:
    """The inverse of :func:`state_dict_key`: a state-dict key -> ``(path,
    rep)``, the reference leaf's path (dict keys as str, the indices of
    ``blocks`` and ``prefix`` as int) and the repetition or layer of a
    stacked leaf (``None`` for a leaf of its own).  A key outside the model's
    layout (``"w"``) is a one-level path."""
    parts = key.split(".")
    head, rest = parts[0], parts[1:]
    n = sum(1 for _ in itertools.takewhile(str.isdigit, rest))   # leading indices
    if head == "blocks" and n >= 2 and len(rest) > 2:
        return ("blocks", int(rest[0]), *rest[2:]), int(rest[1])
    if head in _STACKED_LAYERS and n >= 1 and len(rest) > 1:
        return (head, *rest[1:]), int(rest[0])
    if head == "prefix" and n >= 1 and len(rest) > 1:
        return ("prefix", int(rest[0]), *rest[1:]), None
    return tuple(parts), None


def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys (str) and sequence
    indices (int): ``['blocks'][0]['attn']['wq']``."""
    return "".join(f"[{p}]" if isinstance(p, int) else f"[{p!r}]" for p in path)


def reference_leaves(keys) -> list:
    """State-dict keys grouped by reference leaf, in the reference's flatten
    order (dict keys sorted, sequences by index): a list of ``(keystr,
    members)``, ``members`` the ``(rep, key)`` pairs of the leaf sorted by
    repetition (one pair with ``rep`` None for a leaf that is not stacked)."""
    tree: dict = {}
    for key in keys:
        path, rep = reference_path(key)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node.setdefault(path[-1], []).append((rep, key))
    out = []

    def walk(node, path):
        if isinstance(node, list):
            reps = [r for r, _ in node]
            if (len(node) > 1 and None in reps) or len(set(reps)) != len(reps):
                raise ValueError(f"{keystr(path)}: repetitions {reps} do not stack")
            out.append((keystr(path), sorted(node, key=lambda m: -1 if m[0] is None else m[0])))
            return
        for p in sorted(node):            # str keys of a dict, or the int indices of a sequence
            walk(node[p], path + (p,))

    walk(tree, ())
    return out
