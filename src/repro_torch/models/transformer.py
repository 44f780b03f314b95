"""Decoder-only model assembly: the attention block kinds.

The layer stack is ``prefix_kinds`` followed by repetitions of the config's
``pattern`` super-block.  The reference scans the repetitions over params
stacked along a leading axis; here each repetition is a module of its own and
a Python loop runs them, under ``torch.utils.checkpoint`` when grad is
enabled (the reference's ``jax.checkpoint``).

Params live in an ``nn.Module`` tree whose names are the reference's pytree
keys: ``embed``, ``unembed``, ``final_norm.scale``, ``prefix.<i>.attn.wq`` and
``blocks.<pos>.<rep>.attn.wq`` -- the reference's
``params["blocks"][pos]["attn"]["wq"][rep]``.  So the state-dict key of a leaf
follows from the reference's ``keystr`` path (``models/convert.py``).

Entry points (the reference's, with ``device=`` on the initializers):
  init_params(cfg, key, device)                        -> Model
  forward(params, cfg, tokens, extra_embeds)           -> (logits, aux)
  loss_fn(params, cfg, batch)                          -> (scalar loss, metrics)
  prefill(params, cfg, tokens, t_cache, extra_embeds)  -> (last_logits, state)
  decode_step(params, cfg, token, state, pos)          -> (logits, state)

Every block kind of the reference: the attention kinds, ``mla``, ``rec``
(RG-LRU), ``mlstm`` and ``slstm`` (which have no ``norm2``/MLP), MoE
feed-forwards, deepseek's dense MLA prefix (``attn_dense_prefix``) and its
MTP head, whose term ``loss_fn`` adds.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from repro_torch.core import prng
from repro_torch.distributed import context as dctx
from repro_torch.models import layers, mla, moe, rglru, xlstm

Params = Dict[str, Any]

ATTN_KINDS = ("attn", "attn_local", "attn_chunk", "attn_global")
_MASK_KIND = {"attn": "causal", "attn_local": "local", "attn_chunk": "chunk",
              "attn_global": "causal"}


# --------------------------------------------------------------------------- params

class ParamTree(nn.Module):
    """A nested dict of tensors as a module tree, indexed like the dict.

    Dict entries become parameters (tensors), child trees (dicts) or module
    lists (lists and tuples of dicts); ``tree["attn"]["wq"]`` then reads
    what the reference's ``params["attn"]["wq"]`` reads.
    """

    def __init__(self, tree: Params):
        super().__init__()
        for name, value in tree.items():
            self.add(name, value)

    def add(self, name: str, value):
        if isinstance(value, nn.Module):
            self.add_module(name, value)
        elif isinstance(value, dict):
            self.add_module(name, ParamTree(value))
        elif isinstance(value, (list, tuple)):
            self.add_module(name, nn.ModuleList(
                v if isinstance(v, nn.Module) else ParamTree(v) for v in value))
        else:
            self.register_parameter(name, nn.Parameter(
                value, requires_grad=value.is_floating_point()))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def keys(self):
        return list(self._parameters) + list(self._modules)


class Model(ParamTree):
    """The whole decoder: ``embed``, ``unembed``, ``final_norm``, ``prefix``
    (a list of blocks) and ``blocks`` (per pattern position, a list of one
    block per repetition); each block is a ``ParamTree`` of its own."""

    def __init__(self, tree: Params, cfg=None):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, tokens, extra_embeds=None):
        return forward(self, self.cfg, tokens, extra_embeds)


# --------------------------------------------------------------------------- blocks

def _has_moe(cfg, kind: str) -> bool:
    return cfg.moe is not None and kind in ("attn", "attn_local", "attn_chunk", "attn_global", "mla")


def block_init(key, cfg, kind: str, *, dense_ff: int | None = None, device="cuda") -> Params:
    ks = prng.split(key, 4)
    d = cfg.d_model
    p: Params = {"norm1": layers.norm_init(d, cfg.norm, device=device)}
    if kind in ATTN_KINDS:
        p["attn"] = layers.gqa_init(ks[0], cfg, device=device)
    elif kind == "mla":
        p["attn"] = mla.mla_init(ks[0], cfg, device=device)
    elif kind == "rec":
        p["rec"] = rglru.rglru_init(ks[0], cfg, device=device)
    elif kind == "mlstm":
        p["mix"] = xlstm.mlstm_init(ks[0], cfg, device=device)
        return p  # mLSTM block has no separate MLP
    elif kind == "slstm":
        p["mix"] = xlstm.slstm_init(ks[0], cfg, device=device)
        return p
    else:
        raise ValueError(kind)
    p["norm2"] = layers.norm_init(d, cfg.norm, device=device)
    if _has_moe(cfg, kind) and dense_ff is None:
        p["moe"] = moe.moe_init(ks[1], cfg, device=device)
    else:
        ff = dense_ff if dense_ff is not None else cfg.d_ff
        p["mlp"] = layers.mlp_init(ks[1], d, ff, cfg.mlp, device=device)
    return p


def block_apply(
    params: Params,
    x: torch.Tensor,
    cfg,
    kind: str,
    *,
    positions: torch.Tensor,
    state: Any = None,
    cache_pos=None,
) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Returns (x_out, new_state, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    sp = cfg.seq_shard and x.shape[1] > 1
    h = layers.apply_norm(params["norm1"], x, cfg.norm)
    if sp:
        h = dctx.constrain(h, "batch", None, None)
    if kind in ATTN_KINDS:
        mix, new_state = layers.gqa_apply(
            params["attn"], h, cfg, kind=_MASK_KIND[kind], positions=positions,
            rope=(kind != "attn_global"), cache=state, cache_pos=cache_pos,
        )
    elif kind == "mla":
        mix, new_state = mla.mla_apply(params["attn"], h, cfg, positions=positions,
                                       cache=state, cache_pos=cache_pos)
    elif kind == "rec":
        mix, new_state = rglru.rglru_apply(params["rec"], h, cfg, state)
    elif kind in ("mlstm", "slstm"):
        apply = xlstm.mlstm_apply if kind == "mlstm" else xlstm.slstm_apply
        mix, new_state = apply(params["mix"], h, cfg, state)
        if sp:
            mix = dctx.constrain(mix, "batch", "model", None)
        return x + mix, new_state, aux
    else:
        raise ValueError(kind)
    if sp:
        mix = dctx.constrain(mix, "batch", "model", None)
    x = x + mix
    h2 = layers.apply_norm(params["norm2"], x, cfg.norm)
    if sp:
        h2 = dctx.constrain(h2, "batch", None, None)
    if "moe" in params:
        ff_out, aux = moe.moe_apply(params["moe"], h2, cfg)
    else:
        ff_out = layers.apply_mlp(params["mlp"], h2, cfg.mlp)
    if sp:
        ff_out = dctx.constrain(ff_out, "batch", "model", None)
    return x + ff_out, new_state, aux


def block_init_state(cfg, kind: str, batch: int, t_cache: int, *, device="cuda"):
    """Decode-time state for one block of the given kind (None for train)."""
    if kind in ATTN_KINDS:
        tl = layers.cache_len_for_kind(_MASK_KIND[kind], t_cache, cfg.window, cfg.chunk)
        return layers.init_kv_cache(batch, tl, cfg.num_kv_heads, cfg.resolved_head_dim,
                                    device=device)
    if kind == "mla":
        return mla.mla_init_cache(batch, t_cache, cfg, device=device)
    if kind == "rec":
        return rglru.rglru_init_state(batch, cfg, device=device)
    if kind == "mlstm":
        return xlstm.mlstm_init_state(batch, cfg, device=device)
    if kind == "slstm":
        return xlstm.slstm_init_state(batch, cfg, device=device)
    raise ValueError(kind)


# --------------------------------------------------------------------------- model

def _layer_plan(cfg) -> Tuple[Tuple[str, ...], int]:
    """(prefix kinds, number of pattern repetitions)."""
    n_scanned = cfg.num_layers - len(cfg.prefix_kinds)
    assert n_scanned % len(cfg.pattern) == 0, (
        f"{cfg.name}: {n_scanned} layers not divisible by pattern {cfg.pattern}"
    )
    return cfg.prefix_kinds, n_scanned // len(cfg.pattern)


def _prefix_kind(k: str) -> str:
    return "mla" if k == "attn_dense_prefix" else k


def init_params(cfg, key, *, device="cuda") -> Model:
    """The reference's ``init_params`` from the same key: the same draws
    (``prng`` splits and normals), each leaf a tensor on ``device``."""
    prefix, reps = _layer_plan(cfg)
    ks = prng.split(key, 5)
    vocab = layers.pad_vocab(cfg.vocab_size)
    p: Params = {
        "embed": layers.embed_init(ks[0], vocab, cfg.d_model, device=device),
        "final_norm": layers.norm_init(cfg.d_model, cfg.norm, device=device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = layers.dense_init(ks[1], cfg.d_model, vocab, device=device)
    pk = prng.split(ks[2], max(len(prefix), 1))
    p["prefix"] = [ParamTree(block_init(
        pk[i], cfg, _prefix_kind(k), device=device,
        dense_ff=cfg.dense_d_ff if k == "attn_dense_prefix" else None))
        for i, k in enumerate(prefix)]
    sk = prng.split(ks[3], reps)
    per_pos = [[] for _ in cfg.pattern]
    for k in sk:
        kk = prng.split(k, len(cfg.pattern))
        for i, kind in enumerate(cfg.pattern):
            per_pos[i].append(ParamTree(block_init(kk[i], cfg, kind, device=device)))
    p["blocks"] = [nn.ModuleList(blocks) for blocks in per_pos]
    if cfg.mtp_heads:
        p["mtp"] = {
            "proj": layers.dense_init(ks[4], 2 * cfg.d_model, cfg.d_model, device=device),
            "block": block_init(prng.fold_in(ks[4], 1), cfg, cfg.pattern[0], device=device),
            "norm": layers.norm_init(cfg.d_model, cfg.norm, device=device),
        }
    return Model(p, cfg)


def _embed(params, tokens, extra_embeds):
    x = dctx.embed(params["embed"], tokens)
    if extra_embeds is not None:
        # multimodal stub frontend: precomputed patch/frame embeddings prepended
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return x


def _unembed(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def forward(
    params: Params,
    cfg,
    tokens: torch.Tensor,
    extra_embeds: torch.Tensor | None = None,
    *,
    return_hidden: bool = False,
):
    """Teacher-forced forward pass -> (logits (B, S, vocab_padded), aux)."""
    prefix, reps = _layer_plan(cfg)
    x = dctx.constrain(_embed(params, tokens, extra_embeds), "batch", None, None)
    positions = torch.arange(x.shape[1], device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def prefix_block(x, i):
        x, _, aux = block_apply(params["prefix"][i], x, cfg, _prefix_kind(prefix[i]),
                                positions=positions)
        return x, aux

    def superblock(x, r):
        aux_step = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, kind in enumerate(cfg.pattern):
            x, _, aux = block_apply(params["blocks"][i][r], x, cfg, kind, positions=positions)
            aux_step = aux_step + aux
        return dctx.constrain(x, "batch", "model", None) if cfg.seq_shard else x, aux_step

    for i in range(len(prefix)):
        x, aux = _recomputed(prefix_block, x, i, sharded_only=True)
        aux_total = aux_total + aux
    for r in range(reps):
        x, aux = _recomputed(superblock, x, r)
        aux_total = aux_total + aux
    h = layers.apply_norm(params["final_norm"], x, cfg.norm)
    # under a mesh: DTensor has no rule for the unembed matmul's flatten of
    # (batch, seq) with both sharded (the residual stream is sequence-sharded
    # under cfg.seq_shard), so the sequence is gathered here
    h = dctx.constrain(h, "batch", None, None)
    if return_hidden:
        return h, aux_total
    return h @ _unembed(params, cfg), aux_total


def _recomputed(fn, *args, sharded_only: bool = False):
    """``fn(*args)``; where autograd records, recomputed in the backward
    (``context.recomputed``), so that a block's activations live only
    while its own backward runs.  ``sharded_only``: only under a mesh.  The
    reference recomputes the repeated blocks alone; under a mesh the port
    also recomputes deepseek's dense prefix and MTP block, whose float32
    attention scores would otherwise stay live through the whole step (105 GB
    per GPU at ``train_4k``)."""
    if torch.is_grad_enabled() and (not sharded_only or dctx.current_mesh() is not None):
        return dctx.recomputed(fn, *args)
    return fn(*args)


def _nll(logits, labels):
    if dctx.vocab_sharded(logits):
        # each rank on its own vocabulary shard, the softmax's sums reduced
        # over the shards (the reference's GSPMD reduction); the gather's
        # backward would build the global logits' shape on every rank
        return dctx.vocab_nll(logits, labels)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]


def mtp_hidden(params: Params, cfg, h: torch.Tensor, next_tokens: torch.Tensor) -> torch.Tensor:
    """The MTP head's normed hidden state: ``[h_t ; emb(t+1)]`` projected, one
    block of ``cfg.pattern[0]``, the head's norm.  Position t predicts t+2."""
    emb_next = dctx.embed(params["embed"], next_tokens)
    h2 = torch.cat([h, emb_next], dim=-1) @ params["mtp"]["proj"]

    def block(h2):
        return block_apply(params["mtp"]["block"], h2, cfg, cfg.pattern[0],
                           positions=torch.arange(h2.shape[1], device=h2.device))[0]

    h2 = _recomputed(block, h2, sharded_only=True)
    return layers.apply_norm(params["mtp"]["norm"], h2, cfg.norm)


def loss_fn(params: Params, cfg, batch: Dict[str, torch.Tensor]):
    """Causal LM loss (+ deepseek's MTP term).  Differentiable: with grad
    enabled each repetition of the stack is recomputed in the backward
    (``forward``); ``train.loop.make_train_step`` takes its gradients."""
    tokens, labels = batch["tokens"], batch["labels"]
    extra = batch.get("extra_embeds")
    h, aux = forward(params, cfg, tokens, extra, return_hidden=True)
    if extra is not None:
        h = h[:, extra.shape[1]:]          # loss only over text positions
    unembed = _unembed(params, cfg)
    # keep the big logits tensor vocab-sharded over `model` (the softmax then
    # reduces across shards rather than materialising (B, S, V) per device)
    logits = dctx.constrain((h @ unembed).float(), "batch", None, "model")
    loss = _nll(logits, labels).mean()
    metrics = {"nll": loss, "aux": aux}
    if cfg.mtp_heads and "mtp" in params:
        # multi-token prediction: predict t+2 from [h_t ; emb(t+1)]
        h2 = mtp_hidden(params, cfg, h[:, :-1], tokens[:, 1:])
        # position t of h2 predicts token t+2, whose label is labels[t+1]
        mtp_logits = dctx.constrain((h2 @ unembed).float(), "batch", None, "model")
        mtp_loss = _nll(mtp_logits, labels[:, 1:]).mean()
        metrics["mtp_nll"] = mtp_loss
        loss = loss + 0.3 * mtp_loss
    return loss + 0.01 * aux, metrics


# ------------------------------------------------------------------------- serving

def init_decode_state(cfg, batch: int, t_cache: int, *, device="cuda"):
    """Empty caches: ``prefix`` one per prefix block, ``blocks`` per pattern
    position a list of one per repetition (the reference stacks those)."""
    prefix, reps = _layer_plan(cfg)
    return {
        "prefix": [block_init_state(cfg, _prefix_kind(k), batch, t_cache, device=device)
                   for k in prefix],
        "blocks": tuple([block_init_state(cfg, kind, batch, t_cache, device=device)
                         for _ in range(reps)] for kind in cfg.pattern),
    }


def _run_stack(params, cfg, x, positions, state, cache_pos):
    """Shared prefill/decode driver over the prefix and the repeated blocks."""
    prefix, reps = _layer_plan(cfg)
    new_prefix_states = []
    for pparams, kind, st in zip(params["prefix"], prefix, state["prefix"]):
        x, nst, _ = block_apply(pparams, x, cfg, _prefix_kind(kind), positions=positions,
                                state=st, cache_pos=cache_pos)
        new_prefix_states.append(nst)
    new_block_states = tuple([] for _ in cfg.pattern)
    for r in range(reps):
        for i, kind in enumerate(cfg.pattern):
            x, nst, _ = block_apply(params["blocks"][i][r], x, cfg, kind, positions=positions,
                                    state=state["blocks"][i][r], cache_pos=cache_pos)
            new_block_states[i].append(nst)
        if cfg.seq_shard and x.shape[1] > 1:
            x = dctx.constrain(x, "batch", "model", None)
    return x, {"prefix": new_prefix_states, "blocks": new_block_states}


def prefill(params: Params, cfg, tokens: torch.Tensor, t_cache: int,
            extra_embeds: torch.Tensor | None = None):
    """Process the prompt, fill caches; returns (last-token logits, state)."""
    x = _embed(params, tokens, extra_embeds)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, device=x.device)
    # under a mesh each rank builds only its block of each cache
    state = dctx.new_state(lambda dev: init_decode_state(cfg, b, t_cache, device=dev), x.device)
    x, state = _run_stack(params, cfg, x, positions, state, 0)
    h = layers.apply_norm(params["final_norm"], x[:, -1:], cfg.norm)
    logits = (h @ _unembed(params, cfg))[:, 0].float()
    return logits, state


def decode_step(params: Params, cfg, token: torch.Tensor, state, pos):
    """One decode step: token (B,) at absolute position ``pos`` (scalar)."""
    x = dctx.embed(params["embed"], token)[:, None, :]
    positions = torch.full((1,), int(pos), dtype=torch.int32, device=x.device)
    x, state = _run_stack(params, cfg, x, positions, state, int(pos))
    h = layers.apply_norm(params["final_norm"], x, cfg.norm)
    logits = (h @ _unembed(params, cfg))[:, 0].float()
    return logits, state
