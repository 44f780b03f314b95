"""Shared neural-net layers, as functions over nested params.

Initializers return params (nested dicts of tensors); apply functions take
``(params, x)``, where ``params`` is such a dict or the module tree the model
holds them in (``transformer.ParamTree``): both index by the reference's names.  Each
function is the reference's ``repro.models.layers`` function of the same
name, with the same dtypes at every step: bf16 weights and activations,
float32 norms, RoPE angles and attention scores.

Keys are ``(2,)`` uint32 arrays (``core.prng``); an initializer draws on
``device`` (the card unless the caller asks for the CPU), or returns empty
tensors of the right shape and dtype on ``"meta"``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.kernels import backend


def pad_vocab(v: int, multiple: int = 256) -> int:
    """Pad vocab to a lane/shard-friendly multiple (masked out in the loss)."""
    return -(-v // multiple) * multiple


def init_device(device) -> torch.device:
    """The device an initializer draws on: ``"meta"`` for shapes only, else
    :func:`backend.resolve_device` (which raises where CUDA is asked for and
    absent)."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else backend.resolve_device(dev)


def _normal(key, shape, device) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` on ``device`` (empty on meta)."""
    dev = init_device(device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=dev)
    return prng.normal(key, shape, device=dev)


# --- initializers ------------------------------------------------------------------

def dense_init(key, d_in: int, d_out: int, dtype=torch.bfloat16, *, device="cuda") -> torch.Tensor:
    scale = (1.0 / d_in) ** 0.5
    return (_normal(key, (d_in, d_out), device) * scale).to(dtype)


def embed_init(key, vocab: int, d: int, dtype=torch.bfloat16, *, device="cuda") -> torch.Tensor:
    return (_normal(key, (vocab, d), device) * 0.02).to(dtype)


# --- norms ------------------------------------------------------------------------

def norm_init(d: int, kind: str, *, device="cuda"):
    dev = init_device(device)
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=torch.float32, device=dev),
                "bias": torch.zeros((d,), dtype=torch.float32, device=dev)}
    return {"scale": torch.ones((d,), dtype=torch.float32, device=dev)}


def apply_norm(params, x: torch.Tensor, kind: str) -> torch.Tensor:
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + 1e-6) * params["scale"] + params["bias"]
    else:  # rmsnorm
        var = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + 1e-6) * params["scale"]
    return out.to(x.dtype)


# --- RoPE -------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, *, device="cuda") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32, device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,).  Rotate-half: the two
    halves of the head dim (not interleaved pairs), angles in float32."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)            # (hd/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].to(torch.float32) * freqs         # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- MLPs -------------------------------------------------------------------------

def mlp_init(key, d: int, d_ff: int, kind: str, dtype=torch.bfloat16, *, device="cuda"):
    ks = prng.split(key, 3)
    if kind in ("swiglu", "geglu"):
        return {
            "wi": dense_init(ks[0], d, d_ff, dtype, device=device),
            "wg": dense_init(ks[1], d, d_ff, dtype, device=device),
            "wo": dense_init(ks[2], d_ff, d, dtype, device=device),
        }
    return {
        "wi": dense_init(ks[0], d, d_ff, dtype, device=device),
        "wo": dense_init(ks[2], d_ff, d, dtype, device=device),
    }


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation (the erf form is
    4.7e-4 away from it)."""
    return F.gelu(x, approximate="tanh")


def apply_mlp(params, x: torch.Tensor, kind: str) -> torch.Tensor:
    h = x @ params["wi"]
    if kind == "swiglu":
        h = F.silu(x @ params["wg"]) * h
    elif kind == "geglu":
        h = gelu(x @ params["wg"]) * h
    elif kind == "gelu":
        h = gelu(h)
    elif kind == "relu2":
        h = torch.square(F.relu(h))
    return h @ params["wo"]


# --- attention --------------------------------------------------------------------

def gqa_init(key, cfg, dtype=torch.bfloat16, *, device="cuda"):
    """Standard (possibly grouped-query) attention projections."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    ks = prng.split(key, 4)
    p = {
        "wq": dense_init(ks[0], d, h * hd, dtype, device=device),
        "wk": dense_init(ks[1], d, kv * hd, dtype, device=device),
        "wv": dense_init(ks[2], d, kv * hd, dtype, device=device),
        "wo": dense_init(ks[3], h * hd, d, dtype, device=device),
    }
    if cfg.qkv_bias:
        dev = init_device(device)
        p["bq"] = torch.zeros((h * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kv * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kv * hd,), dtype=dtype, device=dev)
    return p


def _mask_bias(kind: str, q_pos, k_pos, window: int, chunk: int) -> torch.Tensor:
    """Additive mask (0 / -inf) of shape (q, k) for the given attention kind."""
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    ok = kp <= qp                      # causal
    if kind == "local":
        ok &= kp > qp - window
    elif kind == "chunk":
        ok &= torch.div(kp, chunk, rounding_mode="floor") == torch.div(qp, chunk, rounding_mode="floor")
    elif kind == "full_bidir":
        ok = torch.ones_like(ok)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, torch.full_like(zero, -torch.inf))


def multihead_attention(
    q: torch.Tensor,            # (B, S, H, hd)
    k: torch.Tensor,            # (B, T, KV, hd)
    v: torch.Tensor,            # (B, T, KV, hd)
    *,
    kind: str = "causal",       # causal | local | chunk | full_bidir
    window: int = 0,
    chunk: int = 0,
    q_positions: torch.Tensor,  # (S,) absolute positions of queries
    k_positions: torch.Tensor,  # (T,)
    k_valid: torch.Tensor | None = None,  # (T,) bool for cache slots
    q_chunk: int = 512,
) -> torch.Tensor:
    """Query-chunked attention (bounded score memory) with GQA broadcast.

    The reference's formula, step for step: KV heads repeated up to the full
    head count, float32 scores of float32 q and k, the row max clamped at
    -1e30 and the denominator at 1e-30 (a fully masked row gives zeros, not
    NaN), and the weights cast to ``v``'s dtype before the value product.
    Queries go in blocks of ``q_chunk`` (the reference maps over them).
    """
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    group = h // kvh
    if group > 1:
        k = torch.repeat_interleave(k, group, dim=2)
        v = torch.repeat_interleave(v, group, dim=2)
    scale = hd ** -0.5
    kf = k.float()
    valid_bias = None
    if k_valid is not None:
        zero = torch.zeros((), dtype=torch.float32, device=k_valid.device)
        valid_bias = torch.where(k_valid[None, :], zero, torch.full_like(zero, -torch.inf))

    def attend(q_blk, qpos_blk):
        # q_blk: (B, C, H, hd)
        scores = torch.einsum("bchd,bthd->bhct", q_blk.float(), kf)
        scores = scores * scale
        bias = _mask_bias(kind, qpos_blk, k_positions, window, chunk)   # (C, T)
        if valid_bias is not None:
            bias = bias + valid_bias
        scores = scores + bias[None, None]
        smax = torch.clamp(scores.amax(-1, keepdim=True), min=-1e30)
        w = torch.exp(scores - smax)
        denom = torch.clamp(w.sum(-1, keepdim=True), min=1e-30)
        w = (w / denom).to(v.dtype)
        return torch.einsum("bhct,bthd->bchd", w, v)

    vd = v.shape[-1]  # value head dim may differ from hd (MLA)
    if s <= q_chunk:
        out = attend(q, q_positions)
    else:
        out = torch.cat([attend(q[:, i:i + q_chunk], q_positions[i:i + q_chunk])
                         for i in range(0, s, q_chunk)], dim=1)
    return out.reshape(b, s, h, vd)


def cache_len_for_kind(kind: str, seq_len: int, window: int, chunk: int) -> int:
    """KV-cache slots needed per layer kind (bounded for local/chunked layers)."""
    if kind == "local" and window:
        return min(seq_len, window)
    if kind == "chunk" and chunk:
        return min(seq_len, chunk)
    return seq_len


def init_kv_cache(batch: int, t_cache: int, kvh: int, hd: int, dtype=torch.bfloat16, *,
                  device="cuda"):
    """Rolling KV cache: slot positions start at -1 (invalid)."""
    dev = init_device(device)
    return {
        "k": torch.zeros((batch, t_cache, kvh, hd), dtype=dtype, device=dev),
        "v": torch.zeros((batch, t_cache, kvh, hd), dtype=dtype, device=dev),
        "pos": torch.full((t_cache,), -1, dtype=torch.int32, device=dev),
    }


def _write_slots(buf: torch.Tensor, new: torch.Tensor, start: int, dim: int) -> torch.Tensor:
    """``lax.dynamic_update_slice_in_dim`` into a copy: ``new`` at ``start``
    along ``dim`` (start clamped so that ``new`` fits)."""
    start = max(0, min(int(start), buf.shape[dim] - new.shape[dim]))
    out = buf.clone()
    out.narrow(dim, start, new.shape[dim]).copy_(new)
    return out


def gqa_apply(
    params,
    x: torch.Tensor,
    cfg,
    *,
    kind: str,
    positions: torch.Tensor,
    rope: bool = True,
    cache: dict | None = None,
    cache_pos=None,
) -> Tuple[torch.Tensor, dict | None]:
    """Full GQA block: proj -> rope -> (cache update) -> attention -> out proj.

    cache: rolling buffer from :func:`init_kv_cache`; new k/v are written at slot
    ``cache_pos % t_cache`` (local/chunked layers keep only a bounded window; full
    layers size t_cache = max seq so the rolling write is the identity).  The
    cache given is not changed: the updated one is returned.
    """
    b, s, d = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kvh, hd)
    v = v.reshape(b, s, kvh, hd)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None and s == 1:
        # decode: write k,v at the rolling slot, attend over the cache
        t_cache = cache["k"].shape[1]
        slot = int(cache_pos) % t_cache
        ck = _write_slots(cache["k"], k.to(cache["k"].dtype), slot, 1)
        cv = _write_slots(cache["v"], v.to(cache["v"].dtype), slot, 1)
        cpos = _write_slots(cache["pos"], positions.to(torch.int32), slot, 0)
        out = multihead_attention(
            q, ck, cv, kind=kind, window=cfg.window, chunk=cfg.chunk,
            q_positions=positions, k_positions=cpos, k_valid=cpos >= 0,
            q_chunk=cfg.q_chunk,
        )
        new_cache = {"k": ck, "v": cv, "pos": cpos}
    else:
        # train / prefill: attend over the full fresh k,v
        out = multihead_attention(
            q, k, v, kind=kind, window=cfg.window, chunk=cfg.chunk,
            q_positions=positions, k_positions=positions, q_chunk=cfg.q_chunk,
        )
        if cache is not None:
            # fill the cache with the (window) tail of the prompt
            t_cache = cache["k"].shape[1]
            if s >= t_cache:
                new_cache = {
                    "k": k[:, s - t_cache:].to(cache["k"].dtype),
                    "v": v[:, s - t_cache:].to(cache["v"].dtype),
                    "pos": positions[s - t_cache:].to(torch.int32),
                }
            else:
                new_cache = {
                    "k": _write_slots(cache["k"], k.to(cache["k"].dtype), 0, 1),
                    "v": _write_slots(cache["v"], v.to(cache["v"].dtype), 0, 1),
                    "pos": _write_slots(cache["pos"], positions.to(torch.int32), 0, 0),
                }
        else:
            new_cache = None
    out = out.reshape(b, s, h * hd) @ params["wo"]
    return out, new_cache


def cross_attention_init(key, cfg, dtype=torch.bfloat16, *, device="cuda"):
    return gqa_init(key, cfg, dtype, device=device)


def cross_attention_apply(params, x, enc_out, cfg, *, cache=None):
    """Decoder cross-attention over encoder output (keys/values from enc_out)."""
    b, s, d = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ params["wq"]).reshape(b, s, h, hd)
    if cache is not None and "k" in cache:
        k, v = cache["k"], cache["v"]
    else:
        t = enc_out.shape[1]
        k = (enc_out @ params["wk"]).reshape(b, t, kvh, hd)
        v = (enc_out @ params["wv"]).reshape(b, t, kvh, hd)
    t = k.shape[1]
    out = multihead_attention(
        q, k, v, kind="full_bidir",
        q_positions=torch.arange(s, device=x.device),
        k_positions=torch.arange(t, device=x.device),
        q_chunk=cfg.q_chunk,
    )
    out = out.reshape(b, s, h * hd) @ params["wo"]
    return out, {"k": k, "v": v}
