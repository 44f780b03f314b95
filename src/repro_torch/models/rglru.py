"""RG-LRU recurrence block (RecurrentGemma / Griffin).

Temporal mixing: conv1d(width 4) -> gated linear recurrent unit with
input-dependent diagonal decay, computed with a log-depth associative scan
(training/prefill) or a single recurrent step (decode).  State is O(width):
``conv`` (bf16, the last ``conv_width - 1`` inputs) and ``h`` (float32).

The reference's functions of the same names.  Its ``lax.associative_scan`` is
ported as :func:`associative_scan`, the same odd/even recursion in plain
torch: a handful of ops per level, never a loop over the sequence, and the
float32 recurrence combined in the reference's order.  ``softplus`` is
``logaddexp(x, 0)`` as ``jax.nn.softplus`` is (torch's switches to ``x``
above 20), ``gelu`` the tanh form, and square roots are taken in float64 and
rounded once (torch's float32 root on the CPU is not correctly rounded).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from repro_torch.core import prng
from repro_torch.distributed import context as dctx
from repro_torch.models import layers

_C = 8.0  # RG-LRU decay sharpness constant (Griffin appendix)


def rglru_init(key, cfg, dtype=torch.bfloat16, *, device="cuda"):
    d = cfg.d_model
    w = cfg.lru_width or d
    ks = prng.split(key, 7)
    dev = layers.init_device(device)
    if dev.type == "meta":
        conv = torch.empty((cfg.conv_width, w), dtype=dtype, device=dev)
        lam = torch.empty((w,), dtype=torch.float32, device=dev)
    else:
        conv = (prng.normal(ks[2], (cfg.conv_width, w), device=dev) * 0.02).to(dtype)
        # Lambda param: stationary decay in (0.9, 0.999)
        lam = prng.device_uniform_range(ks[5], (w,), 0.4, 0.8, device=dev)
    return {
        "wx": layers.dense_init(ks[0], d, w, dtype, device=device),       # input branch
        "wy": layers.dense_init(ks[1], d, w, dtype, device=device),       # gate branch
        "conv": conv,
        "w_input_gate": layers.dense_init(ks[3], w, w, dtype, device=device),
        "w_rec_gate": layers.dense_init(ks[4], w, w, dtype, device=device),
        "lambda_raw": lam,
        "wo": layers.dense_init(ks[6], w, d, dtype, device=device),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _conv1d(x: torch.Tensor, kernel: torch.Tensor, state: torch.Tensor | None):
    """Causal depthwise conv. x: (B, S, W); kernel: (cw, W); state: (B, cw-1, W).

    The taps are summed by Python's ``sum`` from 0, in the reference's order,
    each add rounded to ``x``'s dtype."""
    cw = kernel.shape[0]
    if state is None:       # zeros ahead of the sequence (as a cat: DTensor's pad fails on torch 2.11)
        xp = torch.cat([torch.zeros_like(x[:, :1]).expand(-1, cw - 1, -1), x], dim=1)
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i: i + s, :] * kernel[i][None, None, :] for i in range(cw))
    new_state = xp[:, -(cw - 1):, :] if cw > 1 else x[:, :0]
    return out, new_state


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
    """a0, b0, a1, b1, ... along ``axis`` (len(a) is len(b) or one more)."""
    n = a.shape[axis] + b.shape[axis]
    shape = list(a.shape)
    shape[axis] = n
    out = a.new_empty(shape)
    idx = [slice(None)] * a.dim()
    idx[axis] = slice(0, n, 2)
    out[tuple(idx)] = a
    idx[axis] = slice(1, n, 2)
    out[tuple(idx)] = b
    return out


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor], axis: int = 0):
    """``lax.associative_scan(fn, elems, axis=axis)``: the same recursion.

    Adjacent pairs are combined and scanned recursively (the odd outputs);
    each even output combines the odd output before it with the original
    element; the first element is the input's."""
    elems = list(elems)
    n = elems[0].shape[axis]
    if n < 2:
        return elems

    def sl(e, start, stop=None, step=1):
        return e[(slice(None),) * axis + (slice(start, stop, step),)]

    reduced = fn([sl(e, 0, n - 1, 2) for e in elems], [sl(e, 1, None, 2) for e in elems])
    odd = associative_scan(fn, reduced, axis)
    if n % 2 == 0:
        even = fn([sl(e, 0, -1) for e in odd], [sl(e, 2, None, 2) for e in elems])
    else:
        even = fn(odd, [sl(e, 2, None, 2) for e in elems])
    even = [torch.cat([sl(e, 0, 1), r], dim=axis) for e, r in zip(elems, even)]
    return [_interleave(e, o, axis) for e, o in zip(even, odd)]


def _combine(c1, c2):
    a1, u1 = c1
    a2, u2 = c2
    return [a1 * a2, a2 * u1 + u2]


def rglru_apply(params, x: torch.Tensor, cfg, state: dict | None = None) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (out (B, S, D), new_state {"conv", "h"})."""
    xb = x @ params["wx"]
    gate_branch = layers.gelu(x @ params["wy"])
    # the conv and the recurrence mix no rows and no features: under a mesh
    # each rank runs them on its own block of (B, S, W), as plain tensors,
    # the state placed as the features are (DTensor would redistribute the
    # scan's strided slices as it saw fit)
    feats = ("batch", None, "model")
    rows = [dctx.constrain(t, *feats) for t in (xb,) + (() if state is None else (state["conv"],))]
    kernel = dctx.param_block(params["conv"], rows[0], None, "model")
    lam = dctx.param_block(params["lambda_raw"], rows[0], "model")
    (xb, *conv_state), placed = dctx.local_blocks(*rows)
    xc, new_conv = _conv1d(xb, kernel, conv_state[0] if conv_state else None)
    xc = placed(xc)

    i_gate = torch.sigmoid(xc @ params["w_input_gate"])
    r_gate = torch.sigmoid(xc @ params["w_rec_gate"])
    gates = (i_gate, r_gate, xc) + (() if state is None else (state["h"][:, None],))
    (i_gate, r_gate, xc, *h0), placed = dctx.local_blocks(
        *(dctx.constrain(t, *feats) for t in gates))
    log_lam = -_C * softplus(lam) * r_gate.float()
    a = torch.exp(log_lam)                                 # decay in (0,1)
    gated_x = (i_gate * xc).float()
    # normalized input scaling (Griffin): sqrt(1 - a^2)
    one = torch.ones((), dtype=torch.float32, device=a.device)
    beta = torch.sqrt(torch.clamp(one - torch.square(a), min=1e-6).double()).float()
    u = beta * gated_x

    h0 = h0[0][:, 0] if h0 else None
    if x.shape[1] == 1 and h0 is not None:
        h = a[:, 0] * h0 + u[:, 0]
        ht = h[:, None, :]
        new_h = h
    else:
        # associative scan over the diagonal recurrence h_t = a_t h_{t-1} + u_t
        if h0 is not None:
            u = torch.cat([(u[:, 0] + a[:, 0] * h0)[:, None], u[:, 1:]], dim=1)
        _, h_s = associative_scan(_combine, [a, u], axis=1)
        ht = h_s
        new_h = h_s[:, -1]
    out = (placed(ht.to(x.dtype)) * gate_branch) @ params["wo"]
    # the state as tensors of its own size, not views into the sequence's
    return out, {"conv": placed(new_conv.clone()), "h": placed(new_h[:, None].clone())[:, 0]}


def rglru_init_state(batch: int, cfg, dtype=torch.bfloat16, *, device="cuda") -> dict:
    w = cfg.lru_width or cfg.d_model
    dev = layers.init_device(device)
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype, device=dev),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=dev),
    }
