"""Multi-head Latent Attention (DeepSeek-V2/V3).

Queries and keys/values are projected through low-rank latents; the KV cache
stores only the compressed latent (kv_lora_rank) plus the shared RoPE key
(qk_rope_dim) per token -- the memory insight of MLA.  Decode attends in the
latent space with the absorbed weights (float32 einsums); a prefill with a
cache expands the cached latents.

The reference's functions of the same names.  Cache writes clamp their start
as ``lax.dynamic_update_slice_in_dim`` does (``layers._write_slots``); the
cache's ``pos`` is shared across the batch, ``(t_cache,)``, -1 where empty.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import prng
from repro_torch.distributed import context as dctx
from repro_torch.models import layers


def mla_init(key, cfg, dtype=torch.bfloat16, *, device="cuda"):
    d = cfg.d_model
    h = cfg.num_heads
    ks = prng.split(key, 8)
    return {
        "w_dq": layers.dense_init(ks[0], d, cfg.q_lora_rank, dtype, device=device),
        "q_norm": layers.norm_init(cfg.q_lora_rank, "rmsnorm", device=device),
        "w_uq": layers.dense_init(ks[1], cfg.q_lora_rank,
                                  h * (cfg.qk_nope_dim + cfg.qk_rope_dim), dtype, device=device),
        "w_dkv": layers.dense_init(ks[2], d, cfg.kv_lora_rank + cfg.qk_rope_dim, dtype,
                                   device=device),
        "kv_norm": layers.norm_init(cfg.kv_lora_rank, "rmsnorm", device=device),
        "w_ukv": layers.dense_init(ks[3], cfg.kv_lora_rank,
                                   h * (cfg.qk_nope_dim + cfg.v_head_dim), dtype, device=device),
        "wo": layers.dense_init(ks[4], h * cfg.v_head_dim, d, dtype, device=device),
    }


def _expand_kv(params, latent: torch.Tensor, cfg):
    """latent (B, T, kv_lora) -> k_nope (B,T,H,nope), v (B,T,H,vdim)."""
    b, t, _ = latent.shape
    kv = layers.matmul(latent, params["w_ukv"]).reshape(b, t, cfg.num_heads,
                                                         cfg.qk_nope_dim + cfg.v_head_dim)
    return kv[..., : cfg.qk_nope_dim], kv[..., cfg.qk_nope_dim:]


def mla_apply(
    params,
    x: torch.Tensor,
    cfg,
    *,
    positions: torch.Tensor,
    cache: dict | None = None,
    cache_pos=None,
) -> Tuple[torch.Tensor, dict | None]:
    b, s, d = x.shape
    h = cfg.num_heads
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim

    qc = layers.apply_norm(params["q_norm"], x @ params["w_dq"], "rmsnorm")
    # under a mesh the heads split over `model` where it divides them
    q = dctx.constrain((qc @ params["w_uq"]).reshape(b, s, h, qd), "batch", None,
                       dctx.heads_axis(h), None)
    q_nope, q_rope = q[..., : cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    q_rope = layers.apply_rope(q_rope, positions, cfg.rope_theta)

    dkv = x @ params["w_dkv"]
    latent = layers.apply_norm(params["kv_norm"], dkv[..., : cfg.kv_lora_rank], "rmsnorm")
    k_rope = dkv[..., cfg.kv_lora_rank:].reshape(b, s, 1, cfg.qk_rope_dim)
    k_rope = layers.apply_rope(k_rope, positions, cfg.rope_theta)

    if cache is not None:
        t_cache = cache["latent"].shape[1]
        slot = int(cache_pos) % t_cache
        clat = layers._write_slots(cache["latent"], latent.to(cache["latent"].dtype), slot, 1)
        ckr = layers._write_slots(cache["k_rope"], k_rope.to(cache["k_rope"].dtype), slot, 1)
        cpos = layers._write_slots(cache["pos"], positions.to(torch.int32), slot, 0)
        new_cache = {"latent": clat, "k_rope": ckr, "pos": cpos}
        if s == 1:
            # absorbed-weight decode: attend directly in the latent space, never
            # re-expanding the cache (the MLA decode optimization)
            w_ukv = params["w_ukv"].reshape(cfg.kv_lora_rank, h, cfg.qk_nope_dim + cfg.v_head_dim)
            w_k, w_v = w_ukv[..., : cfg.qk_nope_dim], w_ukv[..., cfg.qk_nope_dim:]
            q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_k)    # (B,1,H,kv_lora)
            scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
            clat_f = clat.float()
            scores = (
                torch.einsum("bshr,btr->bhst", q_lat.float(), clat_f)
                + torch.einsum("bshr,btzr->bhst", q_rope.float(), ckr.float())
            ) * scale
            ok = (cpos[None, :] <= positions[:, None]) & (cpos >= 0)[None, :]
            zero = torch.zeros((), dtype=torch.float32, device=x.device)
            scores = scores + torch.where(ok, zero, torch.full_like(zero, -torch.inf))[None, None]
            w = torch.softmax(scores, dim=-1)
            ctx_lat = torch.einsum("bhst,btr->bshr", w, clat_f)
            ctx = torch.einsum("bshr,rhv->bshv", ctx_lat, w_v.float())
            out = layers.matmul(dctx.pin(ctx.reshape(b, 1, h * cfg.v_head_dim).to(x.dtype)),
                                params["wo"])
            return out, new_cache
        # the cache is sequence-sharded under a mesh: expanded whole per row
        k_nope_full, v_full = _expand_kv(
            params, dctx.constrain(clat, "batch", None, None), cfg)
        k_rope_full = dctx.constrain(ckr, "batch", None, None, None)
        k_positions, k_valid = cpos, cpos >= 0
    else:
        k_nope_full, v_full = _expand_kv(params, latent, cfg)
        k_rope_full = k_rope
        k_positions, k_valid = positions, None
        new_cache = None

    # concat nope+rope parts; rope key is shared across heads (broadcast),
    # split over `model` as the heads are
    k_rope_full = dctx.constrain(k_rope_full.expand(*k_rope_full.shape[:2], h, cfg.qk_rope_dim),
                                 "batch", None, dctx.heads_axis(h), None)
    k_full = torch.cat([dctx.constrain(k_nope_full, "batch", None, dctx.heads_axis(h), None),
                        k_rope_full], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    out = layers.multihead_attention(
        q_full, k_full, v_full, kind="causal",
        q_positions=positions, k_positions=k_positions, k_valid=k_valid,
        q_chunk=cfg.q_chunk,
    )
    out = layers.matmul(dctx.pin(out.reshape(b, s, h * cfg.v_head_dim)), params["wo"])
    return out, new_cache


def mla_init_cache(batch: int, t_cache: int, cfg, dtype=torch.bfloat16, *, device="cuda") -> dict:
    dev = layers.init_device(device)
    return {
        "latent": torch.zeros((batch, t_cache, cfg.kv_lora_rank), dtype=dtype, device=dev),
        "k_rope": torch.zeros((batch, t_cache, 1, cfg.qk_rope_dim), dtype=dtype, device=dev),
        "pos": torch.full((t_cache,), -1, dtype=torch.int32, device=dev),
    }
