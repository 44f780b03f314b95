"""Mixture-of-experts with sort-based capacity dispatch, its local path.

Dispatch avoids the (T, E, C) dense one-hot tensor (infeasible at E=256):
tokens are replicated k times, sorted by expert id, truncated at per-expert
capacity and scattered into an (E, C, D) buffer.  ``impl="dense"`` keeps a
tiny all-expert einsum for smoke-scale correctness checks.

The reference's functions of the same names, with the same orders wherever
an order decides a result:

* top-k as ``lax.top_k`` takes it: by score, equal scores by expert index (a
  stable descending sort; ``torch.topk`` orders ties as it likes, and
  differently on the CPU and the card);
* the group-by a stable ``argsort`` of the expert ids and a left
  ``searchsorted``;
* the capacity a Python ``int`` of the float product, with the small-T floor
  that keeps decode steps dropless;
* the combine a bf16 sum of each token's k weighted expert outputs in the
  sorted (expert-id) order, rounded after each add -- what the reference's
  ``.at[stok].add`` does, compiled or not.  ``index_add_`` on the card adds
  with atomics in no fixed order, so each token's k slots are gathered and
  reduced here in that order instead.

Under an ambient mesh with a ``model`` axis (``impl="masked"``, experts
divisible by it), ``moe_apply`` takes the reference's expert-parallel
``shard_map`` path (:func:`_moe_ep`): tokens sharded over the batch axes,
each rank's experts a ``model`` slice, the partial outputs summed over
``model``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.distributed import context as dctx
from repro_torch.models import layers


def _stack_init(key, n: int, d_in: int, d_out: int, dtype, device) -> torch.Tensor:
    """``jnp.stack`` of one ``dense_init`` per expert, each draw written into
    a preallocated ``(n, d_in, d_out)`` tensor (a stack of a list would hold
    the leaf twice for a moment: 7.5 GB per leaf at deepseek-v3's width)."""
    dev = layers.init_device(device)
    out = torch.empty((n, d_in, d_out), dtype=dtype, device=dev)
    if dev.type == "meta":
        return out
    for i, k in enumerate(prng.split(key, n)):
        out[i] = layers.dense_init(k, d_in, d_out, dtype, device=dev)
    return out


def moe_init(key, cfg, dtype=torch.bfloat16, *, device="cuda"):
    e = cfg.moe
    d = cfg.d_model
    ks = prng.split(key, 5)
    p = {
        "router": layers.dense_init(ks[0], d, e.num_experts, torch.float32, device=device),
        "wi": _stack_init(ks[1], e.num_experts, d, e.d_ff_expert, dtype, device),
        "wg": _stack_init(ks[2], e.num_experts, d, e.d_ff_expert, dtype, device),
        "wo": _stack_init(ks[3], e.num_experts, e.d_ff_expert, d, dtype, device),
    }
    if e.num_shared:
        p["shared"] = layers.mlp_init(ks[4], d, e.d_ff_expert * e.num_shared, cfg.mlp, dtype,
                                      device=device)
    return p


def _router_probs(logits: torch.Tensor, kind: str, top_k: int):
    """Top-k routing weights, normalized over the selected experts."""
    if kind == "sigmoid":            # deepseek-v3 style scoring
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    # lax.top_k: by score, equal scores in index order (a stable sort)
    top_vals, top_ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_vals, top_ids = top_vals[..., :top_k], top_ids[..., :top_k]
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True), min=1e-9)
    return top_vals, top_ids


def _act(mlp_kind: str):
    return F.silu if mlp_kind == "swiglu" else layers.gelu


def _expert_ffn(p, xe: torch.Tensor, mlp_kind: str) -> torch.Tensor:
    """xe: (E, C, D) -> (E, C, D) through per-expert gated MLPs."""
    h = torch.bmm(xe, p["wi"])
    if mlp_kind in ("swiglu", "geglu"):
        h = _act(mlp_kind)(torch.bmm(xe, p["wg"])) * h
    else:
        h = layers.gelu(h)
    return torch.bmm(h, p["wo"])


def moe_apply(params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss).

    Under an ambient mesh with impl="masked" this runs the layer expert
    parallel (:func:`_moe_ep`): tokens stay sharded over the batch axes
    (replicated over `model`), experts are sharded over `model` (EP), and the
    partial expert outputs are combined with one sum over `model` -- the
    Megatron-style masked-EP collective.
    """
    mesh = dctx.current_mesh()
    e = cfg.moe
    if mesh is not None and e.impl == "masked" and "model" in mesh.mesh_dim_names \
            and e.num_experts % mesh.shape[mesh.mesh_dim_names.index("model")] == 0:
        out, aux = _moe_ep({k: params[k] for k in params.keys() if k != "shared"}, x, cfg, mesh)
        if e.num_shared:
            # the SHARED expert stays OUTSIDE the EP region: inside it would be
            # recomputed per model shard; outside, it is an ordinary TP MLP
            b, s, d = x.shape
            shared = layers.apply_mlp(params["shared"], x.reshape(-1, d), cfg.mlp)
            out = out + shared.reshape(b, s, d)
        return out, aux
    return _moe_local(params, x, cfg)


def _moe_ep(params, x, cfg, mesh):
    """The reference's ``shard_map`` body on this rank's shards.

    ``x`` and the params may be plain tensors (every rank holds the global
    values) or DTensors; either way each is brought to this rank's block --
    the batch slice of the tokens, the ``model`` slice of each expert leaf
    (experts ``[r E/TP, (r+1) E/TP)``), the rest whole -- and the local
    layer runs on plain tensors.  Its output is summed over ``model``, its
    aux averaged over ``model`` (a batch shard's aux, as in the reference,
    whose ``P()`` out spec keeps each shard's own).  The output is a DTensor
    sharded over the batch axes if ``x`` was one (and aux a replicated
    DTensor), else the global tensor (and aux a plain one).
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distributed import sharding

    names = mesh.mesh_dim_names
    bax = dctx.batch_axes()
    bsize = math.prod(mesh.shape[names.index(a)] for a in bax)
    if bsize == 1 or x.shape[0] % bsize != 0:
        bax = ()                                 # tiny batch (or one shard): replicate it
    repl = [Replicate()] * len(names)

    def block(t, dims):
        """``t``'s block on this rank: ``dims`` = {mesh axis: tensor dim}."""
        place = [Shard(dims[a]) if a in dims else Replicate() for a in names]
        if not isinstance(t, DTensor):
            return sharding.shard(t, mesh, place).to_local()
        return t.redistribute(mesh, place).to_local()

    xl = block(x, {a: 0 for a in bax})
    pl = {k: block(v, {"model": 0} if k in ("wi", "wg", "wo") else {})
          for k, v in params.items()}
    e_local = pl["wi"].shape[0]
    expert0 = mesh.get_local_rank("model") * e_local
    out, aux = _moe_local(pl, xl, cfg, expert0=expert0)
    part = [Shard(0) if a in bax else Partial("sum") if a == "model" else Replicate()
            for a in names]
    out = DTensor.from_local(out, mesh, part, run_check=False)
    out = out.redistribute(mesh, [Replicate() if a == "model" else p
                                  for a, p in zip(names, part)])
    aux = DTensor.from_local(aux, mesh, [Partial("avg") if a == "model" else Replicate()
                                         for a in names], run_check=False)
    aux = aux.redistribute(mesh, repl)
    if isinstance(x, DTensor):      # the loss adds aux to DTensors: its gradient is one
        return out, aux
    return out.full_tensor(), aux.to_local()


def _combine(take, order: torch.Tensor, t: int, k: int) -> torch.Tensor:
    """``zeros((t, D)).at[stok].add(gathered)``, where ``take(j)`` gives the
    rows of the sorted ``gathered`` at positions ``j``: each token's k rows
    added from zero in sorted order, rounded per add, one row per token at a
    time (the whole (T*k, D) ``gathered`` is never built)."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    out = None
    for j in torch.sort(inv.reshape(t, k), dim=-1)[0].unbind(1):   # sorted slots per token
        g = take(j)
        out = (torch.zeros_like(g) if out is None else out) + g
    return out


def _moe_local(params, x: torch.Tensor, cfg, expert0: int | None = None):
    """The layer on local tensors.  ``expert0`` (the EP path) says that
    ``params`` hold only experts ``expert0 ..`` of the ``num_experts``: ids
    outside them go to the overflow slot and add nothing."""
    e = cfg.moe
    b, s, d = x.shape
    t = b * s
    n_exp = e.num_experts
    xt = x.reshape(t, d)
    logits = xt.float() @ params["router"]                       # (T, E)
    weights, ids = _router_probs(logits, e.router, e.top_k)      # (T, k)

    # load-balancing aux loss (Switch-style): mean prob * mean assignment
    probs = torch.softmax(logits, dim=-1)
    assign = F.one_hot(ids[:, 0], n_exp).float()
    aux = torch.mean(probs.mean(0) * assign.mean(0)) * n_exp * n_exp

    if e.impl == "dense":
        # all-experts einsum (smoke scale only), as broadcast matmuls over the
        # expert axis: (E, T, F), never a permuted copy of the expert weights
        h = torch.matmul(xt, params["wi"])
        if cfg.mlp in ("swiglu", "geglu"):
            h = _act(cfg.mlp)(torch.matmul(xt, params["wg"])) * h
        out_e = torch.matmul(h, params["wo"])                     # (E, T, D)
        gate = torch.zeros((t, n_exp), dtype=out_e.dtype, device=x.device)
        gate.scatter_(1, ids, weights.to(out_e.dtype))
        out = torch.einsum("etd,te->td", out_e, gate)
    else:
        # sort-based capacity dispatch over the experts this shard owns
        k = e.top_k
        e_local = params["wi"].shape[0]          # = E, or E/TP on the EP path
        cap = int(e.capacity_factor * k * t / n_exp)
        # small-T floor (decode steps, smoke-scale prefill): below 64 assignments
        # run dropless, so keep/drop never depends on the sequence length and
        # prefill(t-1) stays consistent with teacher-forced forward(t)
        cap = max(cap, min(t * k, 64))
        flat_ids = ids.reshape(-1)                               # (T*k,)
        if expert0 is not None:
            flat_ids = flat_ids - expert0                        # local ids; others -> oob
            flat_ids = torch.where((flat_ids < 0) | (flat_ids >= e_local), e_local, flat_ids)
        flat_w = weights.reshape(-1).to(x.dtype)
        tok_ix = torch.arange(t, device=x.device).repeat_interleave(k)   # source token
        order = torch.argsort(flat_ids, stable=True)             # stable group-by
        sid = flat_ids[order]
        stok = tok_ix[order]
        sw = flat_w[order]
        # position within expert group
        grp_start = torch.searchsorted(sid, torch.arange(e_local + 1, device=x.device),
                                       side="left")
        pos_in_e = torch.arange(t * k, device=x.device) - grp_start[torch.clamp(sid, 0, e_local)]
        keep = (pos_in_e < cap) & (sid < e_local)                # capacity drop
        # each kept assignment's slot in the (E, C) buffer; the rest one slot
        # past it.  Only the buffer's rows are gathered (and, on the EP path,
        # only this shard's experts'): no (T*k, D) tensor of every assignment
        slot = torch.where(keep, sid * cap + pos_in_e % cap, e_local * cap)
        src = torch.full((e_local * cap + 1,), t, dtype=stok.dtype, device=x.device)
        src[slot] = stok                    # duplicates only in the dropped last slot
        rows = torch.cat([xt, torch.zeros_like(xt[:1])], dim=0)  # row t: an empty slot's zeros
        buf = rows[src[:-1]].reshape(e_local, cap, d)
        out_buf = _expert_ffn(params, buf, cfg.mlp).reshape(e_local * cap, d)
        out_buf = torch.cat([out_buf, torch.zeros_like(out_buf[:1])], dim=0)
        # each slot's output times its assignment's weight, in slot space:
        # the product's backward keeps the buffer, not k gathered copies.
        # The dropped assignments all read the last slot, whose row is zeros
        slot_w = torch.zeros((e_local * cap + 1,), dtype=sw.dtype, device=x.device)
        slot_w[slot] = sw
        out_buf = out_buf * slot_w[:, None]
        # combine: gather each (token, k) slot's weighted output, sum
        out = _combine(lambda j: out_buf[slot[j]], order, t, k)

    if e.num_shared and "shared" in params:
        out = out + layers.apply_mlp(params["shared"], xt, cfg.mlp)
    return out.reshape(b, s, d), aux
