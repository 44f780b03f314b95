"""Quickstart: the paper's probabilistic-computing stack in five steps.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
"""

from __future__ import annotations

import torch

from repro_torch.core import (
    Corr, bayes_fusion, bayes_inference, bitops, cordiv, latency, logic, prng, sne,
)

P = 0.72
P_MODAL = ((0.55, 0.45),     # RGB says: weak obstacle evidence
           (0.95, 0.05))     # thermal says: strong obstacle evidence


def run(device="cuda", n_bits: int = 1024) -> dict:
    """The five steps on ``device`` with ``n_bits``-bit streams (the reference: 1024)."""
    key = prng.PRNGKey(0)
    out = {"n_bits": n_bits}
    # 1. stochastic number encoding (the memristor SNE, Fig 2a)
    out["stream"] = sne.encode_uncorrelated(key, P, n_bits, device=device)
    # 2. probabilistic logic: AND as a one-gate multiplier (Fig 2d/e)
    out["and_unc"], out["est_unc"], _ = logic.prob_and(key, 0.8, 0.6, n_bits,
                                                       Corr.UNCORRELATED, device=device)
    out["and_pos"], out["est_pos"], _ = logic.prob_and(key, 0.8, 0.6, n_bits,
                                                       Corr.POSITIVE, device=device)
    # 3. CORDIV division (Fig S7's divider), n a subset of d
    kd, ke = prng.split(key)
    d = sne.encode_uncorrelated(kd, 0.8, n_bits, device=device)
    n_sub = d & sne.encode_uncorrelated(ke, 0.5, n_bits, device=device)
    out["quotient"], out["q"] = cordiv.cordiv_scan(n_sub, d, n_bits)
    # 4. Bayesian inference operator (Fig 3, eq 1)
    out["inference"] = bayes_inference(key, p_a=0.57, p_b_given_a=0.72, p_b_given_nota=0.6,
                                       n_bits=n_bits, device=device)
    # 5. Bayesian fusion operator (Fig 4, eq 5) and the timeliness claim
    out["fusion"] = bayes_fusion(key, torch.tensor(P_MODAL), n_bits=n_bits, device=device)
    out["latency"] = latency.memristor_latency(n_bits=100)
    return out


def main(device="cuda") -> None:
    r = run(device)
    n, tr, ftr, rep = r["n_bits"], r["inference"], r["fusion"], r["latency"]
    print(f"1. SNE: encoded p={P} -> measured {float(bitops.decode(r['stream'], n)):.3f} "
          f"({n} bits packed into {r['stream'].shape[-1]} 32-bit words)")
    print(f"2. AND(0.8, 0.6) uncorrelated = {float(r['est_unc']):.3f}  (expect 0.48)")
    print(f"   AND(0.8, 0.6) positively correlated = {float(r['est_pos']):.3f}  (expect min=0.6)")
    print(f"3. CORDIV: P(n)/P(d) = {float(r['q']):.3f}  (expect 0.5)")
    print(f"4. Bayes inference: P(A)=0.57 -> P(A|B)={float(tr.posterior_ratio):.3f} "
          f"(theory {float(tr.posterior_analytic):.3f}; paper's route-planning case)")
    print(f"5. Bayes fusion: fused P(obstacle)={float(ftr.fused_ratio[0]):.3f} "
          f"(analytic {float(ftr.fused_analytic[0]):.3f}); "
          f"memristor latency model: {rep.frame_latency_s*1e3:.1f} ms/frame "
          f"= {rep.fps:.0f} fps (paper: <0.4 ms, 2500 fps)")


if __name__ == "__main__":
    main()
