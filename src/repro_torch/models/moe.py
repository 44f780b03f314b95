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

The expert-parallel ``shard_map`` path of the reference runs under a mesh
only; meshes are not ported (``distributed/context.py``), and ``moe_apply``
raises if one is ever present.
"""

from __future__ import annotations

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
    """x: (B, S, D) -> (out, aux_loss), on the local path (no mesh)."""
    if dctx.current_mesh() is not None:
        raise NotImplementedError(f"moe_apply under a mesh (expert parallelism): "
                                  f"{dctx.MULTI_DEVICE_TODO}")
    return _moe_local(params, x, cfg)


def _combine(gathered: torch.Tensor, order: torch.Tensor, t: int, k: int) -> torch.Tensor:
    """``zeros((t, D)).at[stok].add(gathered)``: each token's k rows of the
    sorted ``gathered`` added from zero in sorted order, rounded per add."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    rows = torch.sort(inv.reshape(t, k), dim=-1)[0]              # sorted slots per token
    g = gathered[rows]                                           # (t, k, D)
    out = torch.zeros_like(g[:, 0])
    for j in range(k):
        out = out + g[:, j]
    return out


def _moe_local(params, x: torch.Tensor, cfg):
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
        # sort-based capacity dispatch
        k = e.top_k
        cap = int(e.capacity_factor * k * t / n_exp)
        # small-T floor (decode steps, smoke-scale prefill): below 64 assignments
        # run dropless, so keep/drop never depends on the sequence length and
        # prefill(t-1) stays consistent with teacher-forced forward(t)
        cap = max(cap, min(t * k, 64))
        flat_ids = ids.reshape(-1)                               # (T*k,)
        flat_w = weights.reshape(-1).to(x.dtype)
        tok_ix = torch.arange(t, device=x.device).repeat_interleave(k)   # source token
        order = torch.argsort(flat_ids, stable=True)             # stable group-by
        sid = flat_ids[order]
        stok = tok_ix[order]
        sw = flat_w[order]
        # position within expert group
        grp_start = torch.searchsorted(sid, torch.arange(n_exp + 1, device=x.device), side="left")
        pos_in_e = torch.arange(t * k, device=x.device) - grp_start[torch.clamp(sid, 0, n_exp)]
        keep = (pos_in_e < cap) & (sid < n_exp)                  # capacity drop
        dst_e = torch.where(keep, sid, n_exp)                    # overflow row
        dst_c = torch.where(keep, pos_in_e % cap, 0)
        buf = torch.zeros((n_exp + 1, cap, d), dtype=x.dtype, device=x.device)
        buf[dst_e, dst_c] = xt[stok]        # duplicates only in the dropped overflow row
        out_buf = _expert_ffn(params, buf[:n_exp], cfg.mlp)
        out_buf = torch.cat([out_buf, torch.zeros_like(out_buf[:1])], dim=0)
        # combine: gather each (token, k) slot's expert output, weight, sum
        gathered = out_buf[dst_e, dst_c] * sw[:, None]           # (T*k, D)
        gathered = torch.where(keep[:, None], gathered, torch.zeros_like(gathered))
        out = _combine(gathered, order, t, k)

    if e.num_shared and "shared" in params:
        out = out + layers.apply_mlp(params["shared"], xt, cfg.mlp)
    return out.reshape(b, s, d), aux
