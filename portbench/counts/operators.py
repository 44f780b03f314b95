"""Least work of the paper's fusion operators on a batch.

Frozen copy of ``chip_smoke.py::Smoke._op_bound`` for ``bayes_decide`` and
``fusion_map``.  Each input byte is counted as read once and each output byte
as written once; the operations are those these inputs need:

* ``bayes_decide`` on p (M, R, K) at n_bits: a stream whose threshold is 0 in
  some modality counts 0, and one at 256 in every modality counts n_bits,
  with no hash.  Every other stream hashes n_bits / 4 entropy words in each
  modality not at 256: per word 15 ALU-only operations and 7 multiply/add
  (the SNE body: the hash's 6 shifts and 6 three-input xors, the compare's OR
  and its combining cone, the pack's funnel shift; the hash's 4 multiplies,
  the counter's add, the compare's subtract, the pack's multiply).  Per word
  of such a stream, the AND of its hashed modalities and a popcount, and an
  add; per class, the argmax's compare and select.
* ``fusion_map`` on p (M, R, K): per input a clip, a log and an add; per
  output a subtract, a max, an exp, an add and a divide: float32 work.
"""

from __future__ import annotations

import dataclasses

import torch

SNE_ALU_OPS, SNE_MULADD_OPS = 15, 7


@dataclasses.dataclass(frozen=True)
class Work:
    """Least work of one launch: ALU-only and multiply/add int32 operations,
    float32 operations and bytes; ``hashed`` the share of streams hashed."""

    alu: float = 0.0
    muladd: float = 0.0
    flops: float = 0.0
    nbytes: float = 0.0
    hashed: float | None = None

    def least_s(self, peaks) -> float:
        """The larger of the operations' and the bytes' least time, in seconds."""
        return max(peaks.int_s(self.alu, self.muladd) + peaks.flop_s(self.flops),
                   peaks.byte_s(self.nbytes))


def bayes_decide(p: torch.Tensor, n_bits: int, block: int = 1 << 22) -> Work:
    """Least work of ``bayes_decide`` on p (M, R, K) float32 at n_bits."""
    m, r, k = p.shape
    w = n_bits // 32
    streams = any_live = 0
    for a in range(0, r, block):
        t = torch.clamp(torch.round(p[:, a:a + block] * 256), 0, 256)
        live = (t > 0) & (t < 256)
        live &= ~(t == 0).any(0)
        streams += int(live.sum())
        any_live += int(live.any(0).sum())
    words = streams * (n_bits // 4)
    alu = words * SNE_ALU_OPS + w * streams + 2 * r * k
    muladd = words * SNE_MULADD_OPS + w * any_live
    return Work(alu=alu, muladd=muladd, nbytes=4 * (m * r * k + r * k + r),
                hashed=streams / (m * r * k))


def fusion_map(m: int, r: int, k: int, prior: bool = False) -> Work:
    """Least work of ``fusion_map`` on p (M, R, K), a prior read or not."""
    return Work(flops=4 * m * r * k + 5 * r * k,
                nbytes=4 * (m * r * k + r * k + (k if prior else 0)))
