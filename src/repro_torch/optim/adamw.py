"""AdamW with float32 master weights, updated in place on the device.

The reference's optimizer is functional: each step maps the old state to a
new one.  At phi3-mini-3.8b's 3.82 B parameters the state is 45.9 GB of
float32 ``master``, ``m`` and ``v``, and a second copy does not fit one 80 GB
card beside the params and gradients.  So :func:`apply` updates each leaf
in place, under ``torch.no_grad``, a slice at a time, with the reference's
arithmetic in the reference's order, and writes the new params into the
gradients' buffers (the new params take the gradients' dtype, as the
reference's ``mp.astype(p.dtype)`` over ``grads`` does).

The state is keyed by the model's parameter names (its state-dict keys):
``OptState(step, master, m, v)`` with ``step`` a 0-d int32 tensor on the
device and ``master``, ``m`` and ``v`` dicts of float32 tensors.

Scalars are 0-d float32 tensors on the leaves' device, never Python floats
in a division (CUDA divides by a CPU scalar through its reciprocal, and
``float / tensor`` is a reciprocal times the float on every device).  The
two square roots are taken in float64 and rounded once: torch's float32
``sqrt`` on the CPU is not correctly rounded.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import numpy as np
import torch

_CHUNK = 1 << 24          # values per slice of a leaf: bounds the update's temporaries


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor                  # 0-d int32
    master: Dict[str, torch.Tensor]     # float32 copy of each param
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def _f32(x, device) -> torch.Tensor:
    """A Python number as the 0-d float32 tensor the reference's weak type
    rounds it to."""
    return torch.tensor(np.float32(x), device=device)


def _named(params) -> Dict[str, torch.Tensor]:
    """A model's parameters (or a dict of tensors) by name."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, in float32 on ``step``'s
    device (``step`` an int32 tensor or a Python int)."""
    step = torch.as_tensor(step, dtype=torch.int32)
    dev = step.device
    s = step.to(torch.float32)
    warm = torch.minimum(s / _f32(max(cfg.warmup_steps, 1), dev), _f32(1.0, dev))
    t = torch.clamp(
        (step - cfg.warmup_steps).to(torch.float32)
        / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), dev),
        0.0, 1.0,
    )
    cos = _f32(0.5, dev) * (_f32(1.0, dev) + torch.cos(_f32(np.pi, dev) * t))
    return (_f32(cfg.lr, dev) * warm) * (
        _f32(cfg.min_lr_ratio, dev) + _f32(1 - cfg.min_lr_ratio, dev) * cos)


def init(params) -> OptState:
    """Zero moments and a float32 master copy of ``params`` (a model or a
    dict of tensors), on the params' device."""
    named = _named(params)
    dev = next(iter(named.values())).device
    master = {k: p.detach().to(torch.float32, copy=True) for k, p in named.items()}
    m = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev) for k, p in named.items()}
    v = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev) for k, p in named.items()}
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev), master=master, m=m, v=v)


def _slices(*tensors):
    """Matching flat slices of at most _CHUNK values of same-shaped tensors."""
    flat = [t.view(-1) for t in tensors]
    n = flat[0].numel()
    for a in range(0, n, _CHUNK):
        yield [f[a:a + _CHUNK] for f in flat]


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (float32): each leaf's squares
    in float32, summed in float64, the root in float64 rounded once."""
    leaves = list(_named(tree).values())
    total = torch.zeros((), dtype=torch.float64, device=leaves[0].device)
    for x in leaves:
        for (c,) in _slices(x.detach().contiguous()):
            total += torch.sum(torch.square(c.to(torch.float32)), dtype=torch.float64)
    return torch.sqrt(total).to(torch.float32)


@torch.no_grad()
def apply(grads, opt_state: OptState, cfg: AdamWConfig):
    """One AdamW update.  Returns ``(new_params, new_opt_state, metrics)``.

    ``grads`` is a dict of gradients by parameter name (contiguous tensors).
    Both it and ``opt_state`` are consumed: ``master``, ``m`` and ``v`` are
    updated in place and returned in the new state, and each gradient's
    buffer receives its new param, ``master`` rounded to the gradient's dtype
    (bf16 gradients give bf16 params, the float32 gradients of a
    microbatched step float32 params).  ``new_params`` is that dict.
    """
    dev = opt_state.step.device
    step = opt_state.step + 1
    gnorm = global_norm(grads)
    scale = torch.minimum(_f32(1.0, dev),
                          _f32(cfg.grad_clip, dev) / torch.maximum(gnorm, _f32(1e-9, dev)))
    lr = schedule(cfg, step)
    b1, b2 = _f32(cfg.b1, dev), _f32(cfg.b2, dev)
    c1, c2 = _f32(1 - cfg.b1, dev), _f32(1 - cfg.b2, dev)
    one = _f32(1.0, dev)
    bc1 = one - torch.pow(b1, step.to(torch.float32))
    bc2 = one - torch.pow(b2, step.to(torch.float32))
    eps, wd = _f32(cfg.eps, dev), _f32(cfg.weight_decay, dev)
    for name, g in grads.items():
        if not g.is_contiguous():
            raise ValueError(f"gradient {name} is not contiguous")
        master, m, v = opt_state.master[name], opt_state.m[name], opt_state.v[name]
        for gc, pc, mc, vc in _slices(g, master, m, v):
            g32 = gc.to(torch.float32)
            mc.mul_(b1).add_((c1 * g32) * scale)
            vc.mul_(b2).add_(c2 * torch.square(g32 * scale))
            root = torch.sqrt((vc / bc2).to(torch.float64)).to(torch.float32)
            pc.sub_(lr * ((mc / bc1) / (root + eps) + wd * pc))
            gc.copy_(pc)                  # the new param, in the gradient's dtype
    metrics = {"grad_norm": gnorm, "lr": lr}
    return grads, OptState(step=step, master=opt_state.master, m=opt_state.m,
                           v=opt_state.v), metrics
