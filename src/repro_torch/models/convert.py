"""Weights carried across from the reference, and back.

The reference's params are a pytree whose ``blocks`` leaves carry a leading
repetition axis (one slice per scanned super-block).  The port's model holds
one module per block, so ``params["blocks"][pos][leaf][rep]`` of the reference
is ``model.blocks[pos][rep].<leaf>`` here, state-dict key
``blocks.<pos>.<rep>.<leaf path>``; every other leaf keeps its path.

Leaves travel as numpy arrays: bf16 through ``ml_dtypes.bfloat16`` (what
``np.asarray`` gives of a JAX bf16 array), or as float32 arrays holding bf16
values (a checkpoint's form), which take the dtype of the port's own leaf
when ``cfg`` is given.
"""

from __future__ import annotations

import ml_dtypes
import numpy as np
import torch
from torch import nn

from repro_torch.kernels import backend
from repro_torch.models import transformer

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


def params_from_reference(tree, cfg=None, *, device="cuda") -> transformer.Model:
    """The reference's ``api.init`` params (numpy leaves) -> a port model on
    ``device`` with the same values, the blocks unstacked per repetition.

    With ``cfg``, float32 leaves that the port holds in bf16 are cast (they
    must hold bf16 values exactly), and the model knows its config.
    """
    dev = backend.resolve_device(device)
    like = None if cfg is None else transformer.init_params(cfg, np.zeros(2, np.uint32),
                                                            device="meta")
    p = {}
    for name in ("embed", "unembed"):
        if name in tree:
            p[name] = _to_torch(tree[name], None if like is None else like[name].dtype, dev)
    p["final_norm"] = _tree(tree["final_norm"], None if like is None else like["final_norm"], dev)
    p["prefix"] = [transformer.ParamTree(_tree(b, None if like is None else like["prefix"][i], dev))
                   for i, b in enumerate(tree["prefix"])]
    blocks = []
    for pos, stacked in enumerate(tree["blocks"]):
        reps = len(next(iter(_leaves(stacked))))
        blocks.append(nn.ModuleList(
            transformer.ParamTree(_tree(_slice(stacked, r),
                                        None if like is None else like["blocks"][pos][r], dev))
            for r in range(reps)))
    p["blocks"] = blocks
    if "mtp" in tree:
        raise NotImplementedError(f"the MTP head is not ported yet: {transformer.NEXT_SLICE_TODO}")
    return transformer.Model(p, cfg)


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


def params_to_reference(model: transformer.Model) -> dict:
    """The inverse of :func:`params_from_reference`: the reference's stacked
    pytree, as numpy leaves (bf16 as ``ml_dtypes.bfloat16``)."""
    out = {name: _to_numpy(model[name]) for name in ("embed", "unembed") if name in model}
    out["final_norm"] = _numpy_tree(model["final_norm"])
    out["prefix"] = [_numpy_tree(b) for b in model["prefix"]]
    out["blocks"] = tuple(_stack([_numpy_tree(b) for b in reps]) for reps in model["blocks"])
    return out


def state_dict_key(keystr: str, rep: int | None = None) -> str:
    """The port's state-dict key of a reference leaf, from its ``keystr``
    path (``"['blocks'][0]['attn']['wq']"``), with ``rep`` the repetition of
    a stacked ``blocks`` leaf."""
    parts = [p.strip("'\"") for p in keystr.strip("[]").split("][")]
    if parts[0] == "blocks":
        if rep is None:
            raise ValueError(f"{keystr}: a stacked blocks leaf needs its repetition")
        parts = parts[:2] + [str(rep)] + parts[2:]
    return ".".join(parts)
