"""Family-dispatch facade over the model zoo.

Launchers (serve, tests) go through these functions so that every
architecture shares one calling convention, the reference's:

  init(cfg, key, device)                 -> params (a ``transformer.Model``)
  loss(params, cfg, batch)               -> (scalar, metrics)
  prefill(params, cfg, batch, t_cache)   -> (last logits, state)
  decode(params, cfg, token, state, pos) -> (logits, state)

``batch`` carries "tokens"/"labels" and, for the vlm stub, "extra_embeds"
(precomputed patch embeddings).  The audio family (enc-dec) is not ported
yet and raises.
"""

from __future__ import annotations

from repro_torch.models import transformer

def _decoder_only(cfg):
    if cfg.family == "audio":
        raise NotImplementedError(f"the enc-dec family ({cfg.name}) is not ported yet: "
                                  f"{transformer.NEXT_SLICE_TODO}")


def init(cfg, key, *, device="cuda"):
    _decoder_only(cfg)
    return transformer.init_params(cfg, key, device=device)


def loss(params, cfg, batch):
    _decoder_only(cfg)
    return transformer.loss_fn(params, cfg, batch)


def prefill(params, cfg, batch, t_cache: int):
    _decoder_only(cfg)
    return transformer.prefill(params, cfg, batch["tokens"], t_cache, batch.get("extra_embeds"))


def decode(params, cfg, token, state, pos):
    _decoder_only(cfg)
    return transformer.decode_step(params, cfg, token, state, pos)


def param_count(params) -> int:
    return int(sum(p.numel() for p in params.parameters()))
