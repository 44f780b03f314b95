"""Hardware Bayesian inference operator (paper Fig 3 / S7, eq (1)).

Circuit (sharing SNEs exactly as the paper does to stay lightweight):

* stream A      ~ P(A)        (prior)
* stream B|A    ~ P(B|A)      (likelihood)
* stream B|notA ~ P(B|notA)
* numerator   n = A AND B|A                          -- probabilistic AND
* denominator d = MUX(select=A, in0=B|notA, in1=B|A) -- weighted adder = P(B)
* posterior     = CORDIV(n, d), n a bitwise subset of d by construction

The MUX's select is the prior stream itself: uncorrelated with both data
inputs (parallel SNEs, Fig S6), and it makes the numerator a subset of the
denominator, as CORDIV needs -- the paper's "maximise the sharing of the
SNEs".
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core import bitops, cordiv, prng, sne
from repro_torch.core.device import _f32
from repro_torch.kernels.backend import resolve_device


def _posterior(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` where ``den > 0`` (den floored at 1e-9), else 0."""
    return torch.where(den > 0, num / torch.clamp(den, min=1e-9), torch.zeros_like(num))


def analytic_posterior(p_a, p_b_given_a, p_b_given_nota, *, device="cuda") -> torch.Tensor:
    """Eq (1): P(A|B) = P(A)P(B|A) / (P(A)P(B|A) + P(notA)P(B|notA))."""
    dev = resolve_device(device)
    p_a = _f32(p_a, dev)
    num = p_a * _f32(p_b_given_a, dev)
    den = num + (1.0 - p_a) * _f32(p_b_given_nota, dev)
    return _posterior(num, den)


@dataclasses.dataclass
class InferenceTrace:
    """Streams at the key circuit nodes (for Fig 3b/3c/3d style reporting)."""

    streams: Dict[str, torch.Tensor]
    n_bits: int
    posterior_scan: torch.Tensor
    posterior_ratio: torch.Tensor
    posterior_analytic: torch.Tensor


def bayes_inference(key, p_a, p_b_given_a, p_b_given_nota, n_bits: int = 100, *,
                    device="cuda") -> InferenceTrace:
    """Run the hardware Bayesian inference operator.  Inputs broadcast."""
    dev = resolve_device(device)
    ka, kba, kbn = prng.split(key, 3)
    s_a = sne.encode_uncorrelated(ka, p_a, n_bits, device=dev)
    s_ba = sne.encode_uncorrelated(kba, p_b_given_a, n_bits, device=dev)
    s_bn = sne.encode_uncorrelated(kbn, p_b_given_nota, n_bits, device=dev)

    numer = bitops.band(s_a, s_ba)
    denom = bitops.bmux(s_a, s_bn, s_ba)   # select=A: (1-pA) P(B|!A) + pA P(B|A)

    # word-parallel CORDIV: bit-identical to the serial circuit
    _, post_scan = cordiv.cordiv_fill(numer, denom, n_bits)
    post_ratio = cordiv.cordiv_ratio(numer, denom)
    return InferenceTrace(
        streams={"A": s_a, "B|A": s_ba, "B|!A": s_bn, "numer": numer, "denom": denom},
        n_bits=n_bits,
        posterior_scan=post_scan,
        posterior_ratio=post_ratio,
        posterior_analytic=analytic_posterior(p_a, p_b_given_a, p_b_given_nota, device=dev),
    )


def bayes_inference_marginal(key, p_a, p_b_given_a, p_b, n_bits: int = 100, *,
                             device="cuda") -> InferenceTrace:
    """Variant where the marginal P(B) is known directly (route planning, Fig 3b).

    posterior = P(A) P(B|A) / P(B); the denominator stream is built by
    superset completion, so CORDIV's correlation requirement holds.
    """
    dev = resolve_device(device)
    ka, kba, kd = prng.split(key, 3)
    p_a, p_ba, p_b = _f32(p_a, dev), _f32(p_b_given_a, dev), _f32(p_b, dev)
    s_a = sne.encode_uncorrelated(ka, p_a, n_bits, device=dev)
    s_ba = sne.encode_uncorrelated(kba, p_ba, n_bits, device=dev)
    numer = bitops.band(s_a, s_ba)
    denom = cordiv.make_superset(kd, numer, p_a * p_ba, p_b, n_bits)
    _, post_scan = cordiv.cordiv_fill(numer, denom, n_bits)
    post_ratio = cordiv.cordiv_ratio(numer, denom)
    analytic = _posterior(p_a * p_ba, p_b)
    return InferenceTrace(
        streams={"A": s_a, "B|A": s_ba, "numer": numer, "denom": denom},
        n_bits=n_bits,
        posterior_scan=post_scan,
        posterior_ratio=post_ratio,
        posterior_analytic=torch.clamp(analytic, 0.0, 1.0),
    )
