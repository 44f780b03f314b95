"""Stochastic number encoders (SNEs) -- Fig 2a / S5 of the paper.

An SNE turns a probability into a Bernoulli bitstream.  In the paper the
entropy comes from the memristor's stochastic V_th and the probability is
programmed by the pulse amplitude ``V_in`` (uncorrelated mode, Fig 2b) or the
comparator reference ``V_ref`` (correlated mode, Fig 2c).  Both modes:

* :func:`encode_uncorrelated` -- parallel SNEs: independent entropy per stream.
* :func:`encode_correlated`   -- one SNE, several comparator references: the
  streams of a group share each entropy byte and are maximally positively
  correlated; ``negate`` models the NOT gate on a comparator output (Fig S5b),
  maximal *negative* correlation.
* :func:`encode_via_device`   -- drives the encoder from the OU memristor
  simulator (:mod:`repro_torch.core.device`).

Streams are packed int32 words (:mod:`repro_torch.core.bitops`), built in the
packed domain by :mod:`repro_torch.core.rng` (counter entropy bytes against
the 8-bit programmed threshold), on the requested device.  The float-uniform
construction survives only in :func:`encode_float_reference`, the
statistical oracle of the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bitops, prng, rng
from repro_torch.core.device import DEFAULT_PARAMS, MemristorParams, _f32, ou_scan
from repro_torch.kernels.backend import resolve_device


def _probs(p, device) -> torch.Tensor:
    return _f32(p, resolve_device(device))


# --- the paper's programmed transfer curves (Fig 2b/2c) ---------------------------

def p_from_vin(v_in, params: MemristorParams = DEFAULT_PARAMS, *, device="cuda") -> torch.Tensor:
    """P_uncorrelated(V_in) = sigmoid(k_unc (V_in - v0_unc))  [Fig 2b fit]."""
    v = _probs(v_in, device)
    return torch.sigmoid(_f32(params.k_unc, v.device) * (v - _f32(params.v0_unc, v.device)))


def vin_from_p(p, params: MemristorParams = DEFAULT_PARAMS, *, device="cuda") -> torch.Tensor:
    """Inverse of :func:`p_from_vin` (programming voltage for a target probability)."""
    p = torch.clamp(_probs(p, device), 1e-6, 1.0 - 1e-6)
    one = _f32(1.0, p.device)
    return _f32(params.v0_unc, p.device) + torch.log(p / (one - p)) / _f32(params.k_unc, p.device)


def p_from_vref(v_ref, params: MemristorParams = DEFAULT_PARAMS, *, device="cuda") -> torch.Tensor:
    """P_correlated(V_ref) = 1 - sigmoid(k_corr (V_ref - v0_corr))  [Fig 2c fit]."""
    v = _probs(v_ref, device)
    return _f32(1.0, v.device) - torch.sigmoid(
        _f32(params.k_corr, v.device) * (v - _f32(params.v0_corr, v.device)))


def vref_from_p(p, params: MemristorParams = DEFAULT_PARAMS, *, device="cuda") -> torch.Tensor:
    """Inverse of :func:`p_from_vref`."""
    p = torch.clamp(_probs(p, device), 1e-6, 1.0 - 1e-6)
    one = _f32(1.0, p.device)
    return _f32(params.v0_corr, p.device) + torch.log((one - p) / p) / _f32(params.k_corr, p.device)


# --- encoders ---------------------------------------------------------------------

def encode_uncorrelated(key, p, n_bits: int, impl: str = "fast", *, device="cuda") -> torch.Tensor:
    """Encode probabilities ``p`` (any shape) into independent packed streams.

    Output shape ``p.shape + (n_words,)`` int32 on ``device``.
    ``impl='threefry'`` swaps the counter-hash entropy for the Threefry
    cipher of ``jax.random.bits``.
    """
    return rng.encode_packed(key, _probs(p, device), n_bits, impl)


def encode_correlated(key, p, n_bits: int, negate=None, impl: str = "fast", *,
                      device="cuda") -> torch.Tensor:
    """Encode ``p`` (shape ``(..., k)``) as ``k`` streams sharing one entropy source.

    ``bit_i = byte < t_i`` -- maximal positive correlation; where ``negate``
    is truthy the complementary comparator ``(255 - byte) < t_i`` -- maximal
    negative correlation with the non-negated streams.
    """
    return rng.encode_packed_correlated(key, _probs(p, device), n_bits, negate=negate, impl=impl)


def encode_float_reference(key, p, n_bits: int, *, device="cuda") -> torch.Tensor:
    """The float32-uniform encoder, kept as a statistical oracle for tests.

    Draws ``(..., n_bits)`` float uniforms (``jax.random.uniform``'s, bit for
    bit) and packs: 32 bits of entropy traffic per stream bit.
    """
    p = _probs(p, device)
    u = prng.device_uniform(key, tuple(p.shape) + (n_bits,), device=p.device)
    return bitops.pack_bits(u < p[..., None])


# Cephes' rational approximations of the normal quantile (jax.scipy.special.ndtri),
# coefficients highest degree first
_P0 = (-5.99633501014107895267E1, 9.80010754185999661536E1, -5.66762857469070293439E1,
       1.39312609387279679503E1, -1.23916583867381258016E0)
_Q0 = (1.0, 1.95448858338141759834E0, 4.67627912898881538453E0, 8.63602421390890590575E1,
       -2.25462687854119370527E2, 2.00260212380060660359E2, -8.20372256168333339912E1,
       1.59056225126211695515E1, -1.18331621121330003142E0)
_P1 = (4.05544892305962419923E0, 3.15251094599893866154E1, 5.71628192246421288162E1,
       4.40805073893200834700E1, 1.46849561928858024014E1, 2.18663306850790267539E0,
       -1.40256079171354495875E-1, -3.50424626827848203418E-2, -8.57456785154685413611E-4)
_Q1 = (1.0, 1.57799883256466749731E1, 4.53907635128879210584E1, 4.13172038254672030440E1,
       1.50425385692907503408E1, 2.50464946208309415979E0, -1.42182922854787788574E-1,
       -3.80806407691578277194E-2, -9.33259480895457427372E-4)
_P2 = (3.23774891776946035970E0, 6.91522889068984211695E0, 3.93881025292474443415E0,
       1.33303460815807542389E0, 2.01485389549179081538E-1, 1.23716634817820021358E-2,
       3.01581553508235416007E-4, 2.65806974686737550832E-6, 6.23974539184983293730E-9)
_Q2 = (1.0, 6.02427039364742014255E0, 3.67983563856160859403E0, 1.37702099489081330271E0,
       2.16236993594496635890E-1, 1.34204006088543189037E-2, 3.28014464682127739104E-4,
       2.89247864745380683936E-6, 6.79019408009981274425E-9)


def ndtri(p: torch.Tensor) -> torch.Tensor:
    """The standard normal quantile in float32 (``jax.scipy.stats.norm.ppf``).

    The reference's piecewise Cephes approximation, operation for operation,
    on ``p``'s device; the platforms' ``log`` and ``sqrt`` may round a
    result an ulp or two apart.
    """
    p = torch.as_tensor(p, dtype=torch.float32)
    dev = p.device

    def f32(v):
        return torch.tensor(np.float32(v), device=dev)

    def polyval(coefs, x):
        y = torch.zeros_like(x)
        for c in coefs:
            y = y * x + f32(c)
        return y

    one, half = f32(1.0), f32(0.5)
    mcp = torch.where(p > f32(-np.expm1(-2.0)), one - p, p)
    mcp = torch.where(mcp == f32(0.0), half, mcp)
    w = mcp - half
    ww = w * w
    big = w + w * ww * (polyval(_P0, ww) / polyval(_Q0, ww))
    big = big * -f32(np.sqrt(2.0 * np.pi))
    z = torch.sqrt(f32(-2.0) * torch.log(mcp))
    first = z - torch.log(z) / z
    inv = one / z
    small = first - polyval(_P2, inv) / polyval(_Q2, inv) / z
    other = first - polyval(_P1, inv) / polyval(_Q1, inv) / z
    x = torch.where(mcp > f32(np.exp(-2.0)), big, torch.where(z >= f32(8.0), small, other))
    x = torch.where(p > f32(1.0 - np.exp(-2.0)), x, -x)
    inf = f32(np.inf)
    return torch.where(p == f32(0.0), -inf, torch.where(p == one, inf, x))


def device_levels(key, p, n_bits: int, params: MemristorParams = DEFAULT_PARAMS, *,
                  device="cuda"):
    """The two sides of :func:`encode_via_device`'s comparator, per stream of
    the flattened ``p``: ``(V_in (S,), V_th (S, n_bits))``.

    ``V_in = vth_mu + vth_sigma * ndtri(clip(p))`` makes
    ``P(V_th,t < V_in) = p`` under the stationary Gaussian; stream ``i``'s
    ``V_th`` is its own OU path under key ``split(key, S)[i]``, all streams
    stepping through time together on ``device``.
    """
    flat = _probs(p, device).reshape(-1)
    dev = flat.device
    v_in = _f32(params.vth_mu, dev) + _f32(params.vth_sigma, dev) * ndtri(
        torch.clamp(flat, 1e-6, 1 - 1e-6))
    keys = prng.split(prng.key_data(key), flat.shape[0])
    eps = prng.normal(keys, (n_bits,), device=dev).T                 # (n_bits, S)
    mu = _f32(params.vth_mu, dev)
    vth = ou_scan(eps, mu, mu, np.float32(params.ou_theta), np.float32(params.ou_sigma_w))
    return v_in, vth.T


def encode_via_device(key, p, n_bits: int, params: MemristorParams = DEFAULT_PARAMS, *,
                      device="cuda") -> torch.Tensor:
    """Encode with entropy drawn from the OU memristor simulator.

    Bit t of a stream is ``V_in > V_th,t`` (:func:`device_levels`): the
    device-faithful path, statistically equivalent to
    :func:`encode_uncorrelated`.  Returns ``p.shape + (n_words,)``.
    """
    p = _probs(p, device)
    v_in, vth = device_levels(key, p, n_bits, params, device=p.device)
    bits = bitops.pack_bits(v_in[:, None] > vth)
    return bits.reshape(tuple(p.shape) + (bitops.n_words(n_bits),))
