"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

mLSTM runs a sequence with the exact chunkwise-parallel formulation (a loop
over chunks of ``cfg.mlstm_chunk``, parallel within each) and decodes with
the O(d_k x d_v) recurrent state.  sLSTM is inherently sequential
(exponential-gated scalar memory with normalizer/stabilizer state): a loop
over the sequence, which is fine at prompt lengths.

The reference's functions of the same names.  The decode step's outer product
of k and v is taken in float32, as the compiled reference takes it (see
``mlstm_apply``).  ``log_sigmoid`` is written the reference's way,
``-softplus(-x)`` with ``softplus = logaddexp(x, 0)``; the reference's
three-operand einsums are contracted here as the weight times one operand,
then the product with the other.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.distributed import context as dctx
from repro_torch.models import layers
from repro_torch.models.rglru import softplus


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


# --------------------------------------------------------------------------- mLSTM

def mlstm_init(key, cfg, dtype=torch.bfloat16, *, device="cuda"):
    d = cfg.d_model
    di = 2 * d                      # up-projection factor 2 (xLSTM paper)
    ks = prng.split(key, 8)

    def dense(k, d_in, d_out, dt=dtype):
        return layers.dense_init(k, d_in, d_out, dt, device=device)
    return {
        "w_up": dense(ks[0], d, di),
        "w_gate": dense(ks[1], d, di),
        "wq": dense(ks[2], di, di),
        "wk": dense(ks[3], di, di),
        "wv": dense(ks[4], di, di),
        "w_i": dense(ks[5], di, cfg.num_heads, torch.float32),
        "w_f": dense(ks[6], di, cfg.num_heads, torch.float32),
        "w_down": dense(ks[7], di, d),
    }


def mlstm_init_state(batch: int, cfg, *, device="cuda") -> dict:
    d = cfg.d_model
    nh = cfg.num_heads
    dh = 2 * d // nh
    dev = layers.init_device(device)
    return {
        "C": torch.zeros((batch, nh, dh, dh), dtype=torch.float32, device=dev),
        "n": torch.zeros((batch, nh, dh), dtype=torch.float32, device=dev),
        "m": torch.full((batch, nh), -1e30, dtype=torch.float32, device=dev),
    }


def _mlstm_chunk(carry, inputs, dh):
    """One chunk of the exact chunkwise-parallel mLSTM.

    carry: (C_hat (B,NH,DK,DV), n_hat (B,NH,DK), m (B,NH)) -- stabilized state
           (true C = C_hat * exp(m)).
    inputs: q,k,v (B,L,NH,DH), log_i/log_f (B,L,NH) for this chunk.
    """
    C_in, n_in, m_in = carry
    q, k, v, log_i, log_f = inputs
    l = q.shape[1]
    scale = dh ** -0.5
    qf = q.float() * scale
    kf = k.float()
    vf = v.float()

    fc = torch.cumsum(log_f, dim=1)                              # (B, L, NH)
    # intra-chunk log weights: dmat[t, s] = fc_t - fc_s + log_i_s  (s <= t)
    dmat = fc[:, :, None, :] - fc[:, None, :, :] + log_i[:, None, :, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=q.device))
    dmat = dmat.masked_fill(~mask[None, :, :, None], -torch.inf)
    # carry log weight at t: fc_t + m_in
    carry_logw = fc + m_in[:, None, :]                           # (B, L, NH)
    m_t = torch.maximum(dmat.amax(2), carry_logw)                # (B, L, NH)
    m_t = torch.clamp(m_t, min=-1e30)
    dexp = torch.exp(dmat - m_t[:, :, None, :])                  # (B, L, S, NH)
    cexp = torch.exp(carry_logw - m_t)                           # (B, L, NH)

    scores = torch.einsum("blhd,bshd->blsh", qf, kf)
    w = scores * dexp
    num = torch.einsum("blsh,bshd->blhd", w, vf) + cexp[..., None] * torch.einsum(
        "blhk,bhkv->blhv", qf, C_in)
    den = w.sum(2) + cexp * torch.einsum("blhk,bhk->blh", qf, n_in)
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]

    # end-of-chunk state
    fc_last = fc[:, -1, :]                                       # (B, NH)
    logw_s = fc_last[:, None, :] - fc + log_i                    # (B, L, NH)
    m_out = torch.maximum(logw_s.amax(1), fc_last + m_in)
    sexp = torch.exp(logw_s - m_out[:, None, :])
    decay = torch.exp(fc_last + m_in - m_out)
    C_out = decay[..., None, None] * C_in + torch.einsum(
        "bshk,bshv->bhkv", sexp[..., None] * kf, vf)
    n_out = decay[..., None] * n_in + torch.einsum("bsh,bshk->bhk", sexp, kf)
    return (C_out, n_out, m_out), h


def _mlstm_chunked(q, k, v, log_i, log_f, state, chunk: int = 256):
    """Exact chunkwise mLSTM: a loop over chunks, parallel within each."""
    b, s, nh, dh = q.shape
    l = min(chunk, s)
    pad = (-s) % l
    if pad:
        def padf(x, fill=0.0):
            return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad), value=fill)
        q, k, v = padf(q), padf(k), padf(v)
        log_i = padf(log_i, -1e30)   # padding never contributes (i gate ~ 0)
        log_f = padf(log_f, 0.0)
    carry = (state["C"], state["n"], state["m"])
    hs = []
    # the chunks as views by one split each: a slice per chunk would cost its
    # backward a zero-filled gradient of the whole sequence
    for part in zip(*(torch.split(x, l, dim=1) for x in (q, k, v, log_i, log_f))):
        carry, h = _mlstm_chunk(carry, part, dh)
        hs.append(h)
    h = torch.cat(hs, dim=1)[:, :s]
    C, n, m = carry
    return h, {"C": C, "n": n, "m": m}


def mlstm_apply(params, x: torch.Tensor, cfg, state: dict | None = None) -> Tuple[torch.Tensor, dict]:
    b, s, d = x.shape
    nh = cfg.num_heads
    di = 2 * d
    dh = di // nh
    up = x @ params["w_up"]
    gate = F.silu(x @ params["w_gate"])
    # under a mesh the features are gathered before the split into heads
    # (as in layers.gqa_apply), and the heads before they are merged
    q, k, v = (dctx.constrain(up @ params[w], "batch", None, None).reshape(b, s, nh, dh)
               for w in ("wq", "wk", "wv"))
    log_i = log_sigmoid(up.float() @ params["w_i"])
    log_f = log_sigmoid(up.float() @ params["w_f"])

    if s == 1 and state is not None:
        # recurrent decode step (exact)
        qs, ks_, vs = q[:, 0], k[:, 0], v[:, 0]
        li, lf = log_i[:, 0], log_f[:, 0]
        m_new = torch.maximum(lf + state["m"], li)
        fgate = torch.exp(lf + state["m"] - m_new)[..., None]
        igate = torch.exp(li - m_new)[..., None]
        # the outer product of bf16 k and v is exact in float32, and the compiled
        # reference keeps it there (its consumer is float32); rounded to bf16 it
        # would part the decode from the chunked prompt by whole logits at d_model 1024
        C = fgate[..., None] * state["C"] + igate[..., None] * (
            ks_.float()[..., :, None] * vs.float()[..., None, :])
        n = fgate * state["n"] + igate * ks_
        scale = dh ** -0.5
        num = torch.einsum("bhk,bhkv->bhv", qs.float() * scale, C)
        den = torch.einsum("bhk,bhk->bh", qs.float() * scale, n).abs()
        h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
        ht = dctx.constrain(h, "batch", None, None).reshape(b, 1, di)
        new_state = {"C": C, "n": n, "m": m_new}
    else:
        # the chunked recurrence on each rank's own rows, as plain tensors
        # (under a mesh: torch 2.11 has no DTensor rule for the backward of
        # its cumsum, a flip); a fresh state is built at the local rows
        parts = (q, k, v, log_i, log_f) + (() if state is None else
                                           tuple(state[n] for n in ("C", "n", "m")))
        blocks, placed = dctx.local_blocks(*(dctx.constrain(t, "batch", *(None,) * (t.dim() - 1))
                                             for t in parts))
        q, k, v, log_i, log_f = blocks[:5]
        state = mlstm_init_state(q.shape[0], cfg, device=q.device) if state is None \
            else dict(zip(("C", "n", "m"), blocks[5:]))
        h, new_state = _mlstm_chunked(q, k, v, log_i, log_f, state, chunk=cfg.mlstm_chunk)
        new_state = {n: placed(t) for n, t in new_state.items()}
        # pinned: its gradient comes from w_down's matmul split over the
        # features, which the backward cannot unflatten into heads that the
        # shards do not divide
        ht = dctx.pin(placed(h).reshape(b, s, di))
    out = (ht.to(x.dtype) * gate) @ params["w_down"]
    return out, new_state


# --------------------------------------------------------------------------- sLSTM

def slstm_init(key, cfg, dtype=torch.bfloat16, *, device="cuda"):
    d = cfg.d_model
    ks = prng.split(key, 5)
    return {
        "w_z": layers.dense_init(ks[0], d, d, dtype, device=device),
        "w_i": layers.dense_init(ks[1], d, d, torch.float32, device=device),
        "w_f": layers.dense_init(ks[2], d, d, torch.float32, device=device),
        "w_o": layers.dense_init(ks[3], d, d, dtype, device=device),
        "ffn": layers.mlp_init(ks[4], d, int(d * 4 // 3) * 2, "swiglu", dtype, device=device),
    }


def slstm_init_state(batch: int, cfg, *, device="cuda") -> dict:
    d = cfg.d_model
    dev = layers.init_device(device)
    return {
        "c": torch.zeros((batch, d), dtype=torch.float32, device=dev),
        "n": torch.zeros((batch, d), dtype=torch.float32, device=dev),
        "m": torch.full((batch, d), -1e30, dtype=torch.float32, device=dev),
        "h": torch.zeros((batch, d), dtype=torch.float32, device=dev),
    }


def slstm_apply(params, x: torch.Tensor, cfg, state: dict | None = None) -> Tuple[torch.Tensor, dict]:
    b, s, d = x.shape
    z_in = torch.tanh((x @ params["w_z"]).float())
    i_in = x.float() @ params["w_i"]
    f_in = x.float() @ params["w_f"]
    o_in = torch.sigmoid((x @ params["w_o"]).float())
    # the recurrence mixes no rows and no features: under a mesh each rank
    # runs it on its own block of (B, d), as plain tensors, the state placed
    # as the gates are (a step of DTensor ops costs more than a step's work)
    gates = (z_in, i_in, f_in, o_in)
    if state is not None:
        gates += tuple(state[k][:, None] for k in ("c", "n", "m", "h"))
    blocks, placed = dctx.local_blocks(*(dctx.constrain(t, "batch", None, "model") for t in gates))
    z_in, i_in, f_in, o_in = blocks[:4]
    if state is None:
        # a fresh state of the local rows (slstm_init_state's values)
        c, n, h = (torch.zeros_like(z_in[:, 0]) for _ in range(3))
        m = torch.full_like(z_in[:, 0], -1e30)
    else:
        c, n, m, h = (t[:, 0] for t in blocks[4:])
    floor = torch.full((), 1e-6, dtype=torch.float32, device=z_in.device)
    hs = []
    # the steps as views by one unbind each: a select per step would cost its
    # backward a zero-filled gradient of the whole sequence
    for z_t, i_t, f_t, o_t in zip(*(t.unbind(1) for t in (z_in, i_in, f_in, o_in))):
        lfm = log_sigmoid(f_t) + m
        m_new = torch.maximum(lfm, i_t)
        fg = torch.exp(lfm - m_new)
        ig = torch.exp(i_t - m_new)
        c = fg * c + ig * z_t
        n = fg * n + ig
        h = o_t * c / torch.maximum(n, floor)
        m = m_new
        hs.append(h)
    # the features whole again for the FFN's column-parallel matmuls
    ht = dctx.constrain(placed(torch.stack(hs, dim=1).to(x.dtype)), "batch", None, None)
    out = x + layers.apply_mlp(params["ffn"], ht, "swiglu")
    return out - x, {k: placed(t[:, None])[:, 0] for k, t in (("c", c), ("n", n), ("m", m),
                                                             ("h", h))}
