"""Public wrappers of the fused Bayes decision.

``bayes_decide``        -- the fused single-pass kernel on the card, its plain
                           torch version (``ref.bayes_decide_ref``) on the CPU.
``bayes_decide_packed`` -- the same decision composed from the packed-domain
                           stages: encode -> AND -> popcount -> argmax.  On the
                           card the stages are the ``sne_encode`` and
                           ``pand_popcount`` kernels; on the CPU their plain
                           versions.  Both draw the same entropy words as
                           ``bayes_decide``, so the two are bit-equal.

This is the multi-modal fusion decision layer (eq (3)): M independent modal
posteriors re-enter the stochastic domain and their AND-fused streams are
popcount-argmaxed.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitops, rng
from repro_torch.kernels import backend
from repro_torch.kernels.bayes_decide.kernel import bayes_decide_cuda
from repro_torch.kernels.bayes_decide.ref import bayes_decide_ref
from repro_torch.kernels.pand_popcount.kernel import pand_popcount_cuda
from repro_torch.kernels.sne_encode.kernel import sne_encode_cuda


def _modal(p_modal, n_bits, device):
    """Validate; p_modal (M, ..., K) -> float32 on ``device`` and its (M, R, K) view."""
    if n_bits % 32 or n_bits <= 0:
        raise ValueError(f"n_bits must be a positive multiple of 32, got {n_bits}")
    p = torch.as_tensor(p_modal, dtype=torch.float32).to(backend.resolve_device(device))
    if p.dim() < 2:
        raise ValueError(f"p_modal must be (M, ..., K), got {tuple(p.shape)}")
    return p, p.reshape(p.shape[0], -1, p.shape[-1])


def _draw_entropy(key, flat_p, n_bits):
    return rng.counter_hash_words(key, tuple(flat_p.shape), n_bits // 4, device=flat_p.device)


def _decide_packed(flat_p: torch.Tensor, rand: torch.Tensor):
    """Packed-domain decision from pre-drawn entropy: encode -> AND -> popcount
    -> argmax, each stage materialised.  Bit-equal to ``bayes_decide_ref``."""
    words = rng.packed_from_bytes(rand, rng.threshold_from_p(flat_p))  # (M, R, K, W)
    joint = words[0]
    for i in range(1, flat_p.shape[0]):
        joint = joint & words[i]
    counts = bitops.popcount(joint)                                    # (R, K)
    return torch.argmax(counts, dim=-1).to(torch.int32), counts


def queued_streams(flat_p: torch.Tensor) -> torch.Tensor:
    """The (row, class) streams of p (M, R, K) that the kernel queues for
    hashing, as a 0-d int64 tensor: those with no modality at level 0 and
    some modality below 256 (the others count 0 or n_bits unhashed)."""
    t = rng.threshold_from_p(flat_p)
    return ((t > 0).all(0) & (t < 256).any(0)).sum()


def _prepare(key, p_modal, n_bits, device):
    """(p on the device, its (M, R, K) view, the key as the launch takes it)."""
    p, flat = _modal(p_modal, n_bits, device)
    return p, flat, rng.seed_words(key) if flat.device.type == "cuda" else key


def _launch(flat, key, n_bits, queued=None):
    if flat.device.type == "cuda":
        return bayes_decide_cuda(*key, flat, n_bits=n_bits, queued=queued)
    if queued is not None:
        queued += queued_streams(flat)
    return bayes_decide_ref(flat, _draw_entropy(key, flat, n_bits))


def bayes_decide(key, p_modal, n_bits: int = 128, *, device="cuda", trace=None):
    """Fused batched Bayes decision over modal posteriors.

    p_modal: (M, ..., K) single-modal class posteriors.  Each (modality,
    decision, class) stream gets independent counter-based entropy
    (conditional independence, eq (3)).  n_bits must be a multiple of 32.

    Returns (decisions (...,) int32 argmax class, counts (..., K) int32
    stream popcounts -- ``counts / counts.sum(-1)`` is the fused posterior).

    With a ``trace`` (:class:`~repro_torch.obs.Tracer`) the call records an
    ``op.bayes_decide`` span with children ``op.prepare`` (conversion,
    reshape, key words) and ``op.launch`` (outputs, launch sizing, launch),
    and counts in the tracer ``bayes_decide.streams``, the (row, class)
    streams of the call, and ``bayes_decide.queued``, those queued for
    hashing: a device tensor the kernel adds to, read by ``trace.totals()``.
    """
    if trace is None:
        p, flat, kw = _prepare(key, p_modal, n_bits, device)
        dec, cnt = _launch(flat, kw, n_bits)
        return dec.reshape(p.shape[1:-1]), cnt.reshape(p.shape[1:])
    with trace.span("op.bayes_decide"):
        with trace.span("op.prepare"):
            p, flat, kw = _prepare(key, p_modal, n_bits, device)
        with trace.span("op.launch"):
            queued = trace.counter("bayes_decide.queued", lambda: torch.zeros(
                (), dtype=torch.int64, device=flat.device))
            dec, cnt = _launch(flat, kw, n_bits, queued)
        trace.add("bayes_decide.streams", flat.shape[1] * flat.shape[2])
        return dec.reshape(p.shape[1:-1]), cnt.reshape(p.shape[1:])


def bayes_decide_packed(key, p_modal, n_bits: int = 128, *, device="cuda"):
    """Unfused packed-domain composition: encode -> M-way AND -> popcount -> argmax.

    Bit-equal to :func:`bayes_decide` (same entropy words), but each stage
    materialises its packed intermediate: on the card, one ``sne_encode``
    launch over every (modality, row, class) stream and one ``pand_popcount``
    launch -- the composition the fused kernel collapses.
    """
    p, flat = _modal(p_modal, n_bits, device)
    m, r, k = flat.shape
    if flat.device.type == "cuda":
        kd0, kd1 = rng.seed_words(key)
        words = sne_encode_cuda(kd0, kd1, flat.reshape(-1), n_bits=n_bits)
        counts = pand_popcount_cuda(words.view(m, r * k, n_bits // 32)).view(r, k)
        dec = torch.argmax(counts, dim=-1).to(torch.int32)
    else:
        dec, counts = _decide_packed(flat, _draw_entropy(key, flat, n_bits))
    return dec.reshape(p.shape[1:-1]), counts.reshape(p.shape[1:])
