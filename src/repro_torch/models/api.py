"""Family-dispatch facade over the model zoo.

Launchers (serve, tests) go through these functions so that every
architecture shares one calling convention, the reference's:

  init(cfg, key, device)                 -> params (an ``nn.Module``)
  loss(params, cfg, batch)               -> (scalar, metrics)
  prefill(params, cfg, batch, t_cache)   -> (last logits, state)
  decode(params, cfg, token, state, pos) -> (logits, state)

``batch`` carries "tokens"/"labels" and, for the vlm and audio stubs,
"extra_embeds" (precomputed patch or frame embeddings).  The audio family
runs the enc-dec model (``encdec``), every other family the decoder
(``transformer``).
"""

from __future__ import annotations

from repro_torch.models import encdec, transformer


def init(cfg, key, *, device="cuda"):
    if cfg.family == "audio":
        return encdec.init_params(cfg, key, device=device)
    return transformer.init_params(cfg, key, device=device)


def loss(params, cfg, batch):
    if cfg.family == "audio":
        return encdec.loss_fn(params, cfg, batch)
    return transformer.loss_fn(params, cfg, batch)


def prefill(params, cfg, batch, t_cache: int):
    if cfg.family == "audio":
        return encdec.prefill(params, cfg, batch["extra_embeds"], batch["tokens"], t_cache)
    return transformer.prefill(params, cfg, batch["tokens"], t_cache, batch.get("extra_embeds"))


def decode(params, cfg, token, state, pos):
    if cfg.family == "audio":
        return encdec.decode_step(params, cfg, token, state, pos)
    return transformer.decode_step(params, cfg, token, state, pos)


def param_count(params) -> int:
    return int(sum(p.numel() for p in params.parameters()))
