"""Encoder-decoder model (seamless-m4t-large-v2 backbone).

The encoder consumes precomputed audio frame embeddings (the modality
frontend is a stub, as in the reference); the decoder is autoregressive text
with self- and cross-attention.

The reference's functions of the same names.  Its stacks are scanned over
params stacked per layer; here each layer is a module of its own
(``enc_blocks.<layer>.<leaf>``, ``dec_blocks.<layer>.<leaf>``) and a Python
loop runs them, under ``torch.utils.checkpoint`` when grad is enabled.  The
decode state holds one self-attention cache and one cross k/v per decoder
layer, in lists (the reference stacks them).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils import checkpoint

from repro_torch.core import prng
from repro_torch.distributed import context as dctx
from repro_torch.models import layers
from repro_torch.models.transformer import ParamTree, Params, _nll


class Model(ParamTree):
    """The whole enc-dec model: ``embed``, ``enc_blocks`` and ``dec_blocks``
    (one block per layer), ``enc_norm``, ``final_norm`` and ``unembed``."""

    def __init__(self, tree: Params, cfg=None):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, frames, tokens):
        return forward(self, self.cfg, frames, tokens)


def _enc_block_init(key, cfg, device):
    ks = prng.split(key, 2)
    return {
        "norm1": layers.norm_init(cfg.d_model, cfg.norm, device=device),
        "attn": layers.gqa_init(ks[0], cfg, device=device),
        "norm2": layers.norm_init(cfg.d_model, cfg.norm, device=device),
        "mlp": layers.mlp_init(ks[1], cfg.d_model, cfg.d_ff, cfg.mlp, device=device),
    }


def _dec_block_init(key, cfg, device):
    ks = prng.split(key, 3)
    return {
        "norm1": layers.norm_init(cfg.d_model, cfg.norm, device=device),
        "self_attn": layers.gqa_init(ks[0], cfg, device=device),
        "norm_x": layers.norm_init(cfg.d_model, cfg.norm, device=device),
        "cross_attn": layers.cross_attention_init(ks[1], cfg, device=device),
        "norm2": layers.norm_init(cfg.d_model, cfg.norm, device=device),
        "mlp": layers.mlp_init(ks[2], cfg.d_model, cfg.d_ff, cfg.mlp, device=device),
    }


def init_params(cfg, key, *, device="cuda") -> Model:
    ks = prng.split(key, 5)
    vocab = layers.pad_vocab(cfg.vocab_size)
    return Model({
        "embed": layers.embed_init(ks[2], vocab, cfg.d_model, device=device),
        "enc_blocks": [ParamTree(_enc_block_init(k, cfg, device))
                       for k in prng.split(ks[0], cfg.enc_layers)],
        "dec_blocks": [ParamTree(_dec_block_init(k, cfg, device))
                       for k in prng.split(ks[1], cfg.dec_layers)],
        "enc_norm": layers.norm_init(cfg.d_model, cfg.norm, device=device),
        "final_norm": layers.norm_init(cfg.d_model, cfg.norm, device=device),
        "unembed": layers.dense_init(ks[3], cfg.d_model, vocab, device=device),
    }, cfg)


def _layers(body, x, blocks):
    """The reference's ``_maybe_scan`` over ``jax.checkpoint(block)``."""
    for bp in blocks:
        x = checkpoint.checkpoint(body, x, bp, use_reentrant=False) \
            if torch.is_grad_enabled() else body(x, bp)
    return x


def encode(params: Params, cfg, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T_enc, d_model) precomputed frame embeddings -> encoder output."""
    frames = frames.to(torch.bfloat16)
    positions = torch.arange(frames.shape[1], device=frames.device)

    def block(x, bp):
        h = layers.apply_norm(bp["norm1"], x, cfg.norm)
        # float32 weights (a model after a microbatched step) take the bf16
        # frames' first norm up to float32, as the reference's matmul does
        h = h.to(torch.promote_types(h.dtype, bp["attn"]["wq"].dtype))
        mix, _ = layers.gqa_apply(bp["attn"], h, cfg, kind="full_bidir", positions=positions,
                                  rope=True)
        x = x + mix
        h2 = layers.apply_norm(bp["norm2"], x, cfg.norm)
        x = x + layers.apply_mlp(bp["mlp"], h2, cfg.mlp)
        return dctx.constrain(x, "batch", "model", None) if cfg.seq_shard else x

    x = _layers(block, frames, params["enc_blocks"])
    return layers.apply_norm(params["enc_norm"], x, cfg.norm)


def _dec_block(bp, x, enc_out, cfg, positions, self_cache=None, cross_cache=None,
               cache_pos=None):
    h = layers.apply_norm(bp["norm1"], x, cfg.norm)
    mix, new_self = layers.gqa_apply(bp["self_attn"], h, cfg, kind="causal", positions=positions,
                                     cache=self_cache, cache_pos=cache_pos)
    x = x + mix
    hx = layers.apply_norm(bp["norm_x"], x, cfg.norm)
    cross, new_cross = layers.cross_attention_apply(bp["cross_attn"], hx, enc_out, cfg,
                                                    cache=cross_cache)
    x = x + cross
    h2 = layers.apply_norm(bp["norm2"], x, cfg.norm)
    return x + layers.apply_mlp(bp["mlp"], h2, cfg.mlp), new_self, new_cross


def _logits(params, cfg, x):
    return layers.apply_norm(params["final_norm"], x, cfg.norm) @ params["unembed"]


def forward(params: Params, cfg, frames: torch.Tensor, tokens: torch.Tensor):
    """Teacher-forced enc-dec forward -> (logits (B, S_dec, vocab_padded), aux)."""
    enc_out = encode(params, cfg, frames)
    x = params["embed"][tokens]
    positions = torch.arange(tokens.shape[1], device=x.device)

    def block(x, bp):
        out, _, _ = _dec_block(bp, x, enc_out, cfg, positions)
        return dctx.constrain(out, "batch", "model", None) if cfg.seq_shard else out

    x = _layers(block, x, params["dec_blocks"])
    return _logits(params, cfg, x), torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params: Params, cfg, batch: Dict[str, torch.Tensor]):
    logits, aux = forward(params, cfg, batch["extra_embeds"], batch["tokens"])
    loss = _nll(logits.float(), batch["labels"]).mean()
    return loss, {"nll": loss, "aux": aux}


def prefill(params: Params, cfg, frames: torch.Tensor, tokens: torch.Tensor, t_cache: int):
    """Encode + teacher-forced decoder pass filling the self caches and the
    cross k/v; returns (last-token logits, state)."""
    enc_out = encode(params, cfg, frames)
    b, s = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(s, device=x.device)
    hd = cfg.resolved_head_dim
    state = {"self": [], "cross": []}
    for bp in params["dec_blocks"]:
        cache = layers.init_kv_cache(b, t_cache, cfg.num_kv_heads, hd, device=x.device)
        x, new_self, new_cross = _dec_block(bp, x, enc_out, cfg, positions, self_cache=cache,
                                            cache_pos=0)
        state["self"].append(new_self)
        state["cross"].append(new_cross)
    logits = _logits(params, cfg, x[:, -1:])[:, 0].float()
    return logits, state


def decode_step(params: Params, cfg, token: torch.Tensor, state, pos):
    """One decoder step against the self caches and the fixed cross k/v."""
    x = params["embed"][token][:, None, :]
    positions = torch.full((1,), int(pos), dtype=torch.int32, device=x.device)
    new_self = []
    for bp, self_c, cross_kv in zip(params["dec_blocks"], state["self"], state["cross"]):
        x, nst, _ = _dec_block(bp, x, None, cfg, positions, self_cache=self_c,
                               cross_cache=cross_kv, cache_pos=int(pos))
        new_self.append(nst)
    logits = _logits(params, cfg, x)[:, 0].float()
    return logits, {"self": new_self, "cross": state["cross"]}
