"""Plain references of the paper's fusion operators, on chosen rows of a batch.

Frozen copies of the semantics of ``src/repro_torch/kernels/bayes_decide/ref.py``
(with the counters of ``core/rng.py::counter_hash_words``) and of
``src/repro_torch/kernels/fusion_map/ref.py`` (eq 5).  They read the benchmark's
own inputs and compute each chosen row from them alone.

``bayes_decide`` on p (M, R, K): stream (m, r, k) draws the entropy words
``((m * R + r) * K + k) * n_rand + i`` (mod 2**32, ``n_rand = n_bits / 4``),
each word gives 4 comparator bytes, a stream bit is ``byte < round(p * 256)``,
a class counts the popcount of the AND over modalities, and the decision is
the first class of largest count.

``precision="bfloat16"`` is the control: the posteriors are rounded to
bfloat16 before the DAC threshold (the stochastic operator) or the whole of
eq 5 is computed in bfloat16 (the analytic one).
"""

from __future__ import annotations

import torch

from portbench.reference import hashing


def _as_precision(p: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float32":
        return p
    if precision == "bfloat16":
        return p.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"unknown precision {precision!r}")


def decide_rows(p: torch.Tensor, rows: torch.Tensor, key, n_bits: int,
                precision: str = "float32", block: int = 4096):
    """(decisions (n,) int32, counts (n, K) int32) of rows ``rows`` of the batch p (M, R, K)."""
    m, r, k = p.shape
    n_rand = n_bits // 4
    kd0, kd1 = hashing.seed_words(key)
    word = torch.arange(n_rand, dtype=torch.int64, device=p.device)
    cls = torch.arange(k, dtype=torch.int64, device=p.device)
    mod = torch.arange(m, dtype=torch.int64, device=p.device)
    decs, cnts = [], []
    for a in range(0, rows.numel(), block):
        idx = rows[a:a + block].to(device=p.device, dtype=torch.int64)
        t = hashing.thresholds(_as_precision(p[:, idx], precision))          # (M, n, K)
        stream = (mod[:, None, None] * r + idx[None, :, None]) * k + cls[None, None, :]
        ctr = (stream[..., None] * n_rand + word) & hashing.MASK32           # (M, n, K, n_rand)
        words = hashing.word_hash(ctr, kd0, kd1)
        total = torch.zeros(t.shape[1:], dtype=torch.int32, device=p.device)
        for byte in range(4):
            lane = (words >> (8 * byte)) & 0xFF
            joint = torch.all(lane < t[..., None], dim=0)                    # (n, K, n_rand)
            total += joint.sum(-1, dtype=torch.int32)
        decs.append(torch.argmax(total, dim=-1).to(torch.int32))
        cnts.append(total)
    return torch.cat(decs), torch.cat(cnts)


def fusion_rows(p: torch.Tensor, rows: torch.Tensor, precision: str = "float64",
                block: int = 65536) -> torch.Tensor:
    """Eq 5 with a uniform prior over rows ``rows`` of p (M, R, K): (n, K) in
    float64 (the reference) or bfloat16 (the control), returned as float64."""
    m, _, k = p.shape
    dtype = {"float64": torch.float64, "bfloat16": torch.bfloat16}[precision]
    # the uniform prior as float32(1 / K), the value the configuration states
    log_prior = (m - 1) * torch.log(torch.tensor(1.0 / k, dtype=torch.float32).to(dtype))
    out = []
    for a in range(0, rows.numel(), block):
        idx = rows[a:a + block].to(device=p.device, dtype=torch.int64)
        x = p[:, idx].to(dtype)
        logq = torch.log(torch.clamp(x, 1e-9, 1.0)).sum(0) - log_prior.to(x.device)
        logq = logq - logq.max(dim=-1, keepdim=True).values
        q = torch.exp(logq)
        out.append((q / q.sum(dim=-1, keepdim=True)).to(torch.float64))
    return torch.cat(out)
