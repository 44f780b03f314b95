"""Volatile memristor device model calibrated to the paper's measurements.

Fig 1 / S2 / S4 of the paper characterise solution-processed hBN filamentary
memristors:

* cycle-to-cycle threshold voltage  V_th  ~ N(2.08 V, 0.28 V)
* cycle-to-cycle hold voltage       V_hold~ N(0.98 V, 0.30 V)
* per-cycle V_th trajectory follows an Ornstein-Uhlenbeck (mean-reverting) process
* device-to-device coefficient of variation in V_th ~ 8 %
* switching time ~50 ns, relaxation ~1,100 ns (< 4 us per encoded bit),
  switching energy ~0.16 nJ, endurance > 1e6 cycles.

This module is the *simulator* side of the reproduction: it generates
switching trajectories statistically indistinguishable (by the paper's own OU
fit) from the measured devices, and carries the timing and energy constants
of :mod:`repro_torch.core.latency` and the crossbar noise model
(:mod:`repro_torch.bayesnet.noise`).

Draws come from :func:`~repro_torch.core.prng.normal` on the requested
device.  The OU path is a recurrence over time: :func:`ou_scan` runs it as
one loop over time steps, each step a few torch operations over all
streams and devices at once, on the device (the reference's ``lax.scan``;
20,000 steps at Fig 1's size).  Each step rounds as the reference's, so the
same noise gives the reference's path bit for bit; the noise itself agrees
within a few ulp (:func:`~repro_torch.core.prng.erf_inv`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.kernels.backend import resolve_device


@dataclasses.dataclass(frozen=True)
class MemristorParams:
    """Calibrated constants from the paper (all SI units)."""

    vth_mu: float = 2.08          # V   (Fig 1c)
    vth_sigma: float = 0.28       # V
    vhold_mu: float = 0.98        # V
    vhold_sigma: float = 0.30     # V
    d2d_cv: float = 0.08          # device-to-device CV of V_th
    # OU process dV_t = theta * (mu - V_t) dt + sigma_w dW_t (dt = 1 cycle).
    ou_theta: float = 0.35        # mean-reversion magnitude (Fig S4 fit regime)
    t_switch: float = 50e-9       # s  (Fig S2)
    t_relax: float = 1.1e-6       # s
    t_bit: float = 4e-6           # s  -- paper: "<4 us in total per bit"
    e_switch: float = 0.16e-9     # J  (Fig S2)
    endurance_cycles: float = 1e6
    switching_ratio: float = 1e5  # HRS/LRS resistance ratio (Fig 1b)
    # Empirical SNE transfer curves (Fig 2b / 2c sigmoid fits).
    k_unc: float = 3.56
    v0_unc: float = 2.24
    k_corr: float = 11.5
    v0_corr: float = 0.57

    @property
    def ou_sigma_w(self) -> float:
        """Wiener increment scale chosen so the OU stationary std equals vth_sigma.

        For the AR(1) discretisation x' = x + theta (mu - x) + s_w eps, stationary
        variance is s_w^2 / (1 - (1 - theta)^2).
        """
        return self.vth_sigma * float(np.sqrt(1.0 - (1.0 - self.ou_theta) ** 2))

    @property
    def reads_per_bit(self) -> float:
        """Switching cycles one encoded stream bit integrates (t_bit / t_switch)."""
        return self.t_bit / self.t_switch

    @property
    def read_cv(self) -> float:
        """Effective cycle-to-cycle CV of one comparator read.

        The V_th trajectory has stationary CV ``vth_sigma / vth_mu`` per
        switching cycle, but one encoded bit integrates ``reads_per_bit``
        cycles (paper: < 4 us per bit at ~50 ns switching), so the threshold
        jitter an individual read sees is attenuated by ``sqrt(reads_per_bit)``.
        This is the calibrated cycle-to-cycle term of the crossbar
        :class:`~repro.bayesnet.noise.NoiseModel`.
        """
        return (self.vth_sigma / self.vth_mu) / float(np.sqrt(self.reads_per_bit))

    @property
    def wear_tau_epochs(self) -> float:
        """Read epochs until endurance wear doubles the read-noise *variance*.

        Two measured ingredients, no free constants:

        * The OU fit (:func:`fit_ou` / ``ou_theta``): inter-epoch V_th
          correlation decays as ``(1 - theta)^n`` over the ``reads_per_bit``
          switching cycles one read epoch spans -- ``(1 - 0.35)^80 ~ 1e-15``
          -- so successive :meth:`~repro.bayesnet.noise.NoiseModel.with_cycle`
          epochs are *independent* re-draws, which is exactly how the noise
          model re-keys them.
        * The endurance trace (Fig 1e, :func:`endurance_trace`): degradation
          accumulates as a variance random walk that reaches the fresh-device
          read variance after ``endurance_cycles`` switching events; in read
          epochs that is ``endurance_cycles / reads_per_bit``.
        """
        return self.endurance_cycles / self.reads_per_bit


def wear_scale(cycle: float, tau: float) -> float:
    """Endurance-wear multiplier on the per-read threshold CV at ``cycle``.

    Fresh-device read variance plus a linearly accumulating wear term:
    ``sqrt(1 + cycle / tau)``, with ``tau`` in read epochs
    (:attr:`MemristorParams.wear_tau_epochs`).  Exactly ``1.0`` at
    ``cycle <= 0`` so a fresh array reproduces the calibrated ``read_cv``
    bit-for-bit.
    """
    c = float(cycle)
    if c <= 0.0:
        return 1.0
    return float(np.sqrt(1.0 + c / float(tau)))


DEFAULT_PARAMS = MemristorParams()


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _add_to_odd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` in float64, rounded to odd: the exact sum where it is a
    float64, else the one of its two float64 neighbours whose last bit is 1.

    TwoSum gives the add's exact error; where it is not zero and the
    nearest-rounded sum is even, the sum steps one ulp toward the exact
    value (one step of the bit pattern, away from zero where the error has
    the sum's sign).  A sum rounded to odd in 53 bits and then to nearest in
    24 is the sum correctly rounded to float32 (53 >= 24 + 2).
    """
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    bits = s.view(torch.int64)
    inexact_even = (err != 0) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where(inexact_even, bits + step, bits).view(torch.float64)


def _ou_steps(x_prev: torch.Tensor, mu, theta, kick) -> torch.Tensor:
    """The OU step from each ``x_prev`` at once (any leading axes): both FMAs
    correctly rounded -- the float32 products exact in float64, each add
    rounded to odd (:func:`_add_to_odd`), then once to float32."""
    pull = (mu - x_prev).float().double() * theta
    pull = _add_to_odd(pull, x_prev.double()).float()
    return _add_to_odd(pull.double(), kick).float()


def ou_scan(eps: torch.Tensor, mu, x0, theta, s_w) -> torch.Tensor:
    """The AR(1) recurrence ``x' = x + theta (mu - x) + s_w e`` over ``eps``'s
    leading (time) axis, every other axis at once; returns the path, the
    shape of ``eps``.

    The reference's compiled scan body contracts both multiply-adds into
    fused multiply-adds: ``x' = fma(s_w, e, fma(theta, mu - x, x))``.  The
    loop takes each FMA's float32 product exactly in float64, adds in
    float64 and rounds to float32: the correctly rounded FMA unless the
    float64 add lands on a float32 midpoint it did not hold exactly (then
    rounding twice can miss by an ulp).  So the whole path is then checked at
    once by :func:`_ou_steps`, which rounds each add to odd first and is
    correct on every operand; the loop resumes after the first step that
    differs, with that step's correct value.  The same noise gives the
    reference's path bit for bit.  ``s_w * e`` is taken for all steps at once.
    """
    dev = eps.device
    n = eps.shape[0]
    mu = _f32(mu, dev).to(torch.float64)
    theta = _f32(theta, dev).to(torch.float64)
    x = _f32(x0, dev).expand(eps.shape[1:]).clone()
    kick = _f32(s_w, dev).to(torch.float64) * eps.to(torch.float64)
    path = torch.empty_like(eps)
    pull = torch.empty(x.shape, dtype=torch.float64, device=dev)
    t0, before = 0, x
    while t0 < n:
        for t in range(t0, n):
            torch.sub(mu, x, out=pull)
            # mu - x rounded to float32, then fma(theta, ., x) and fma(s_w, e, .)
            pull = pull.float().double().mul_(theta).add_(x)
            pull = pull.float().double().add_(kick[t])
            x = path[t]
            x.copy_(pull)
        prev = torch.cat([before[None], path[t0:n - 1]])
        exact = _ou_steps(prev, mu, theta, kick[t0:])
        wrong = (exact.view(torch.int32) != path[t0:].view(torch.int32)).reshape(n - t0, -1).any(1)
        if not bool(wrong.any()):
            break
        t = t0 + int(torch.nonzero(wrong)[0])      # every step before it holds
        path[t] = exact[t - t0]
        before = x = path[t]
        t0 = t + 1
    return path


def sample_ou_path(key, n: int, params: MemristorParams = DEFAULT_PARAMS, mu=None, x0=None,
                   *, device="cuda") -> torch.Tensor:
    """Sample an OU trajectory of per-cycle V_th values, shape ``(n,) + shape(mu)``.

    ``mu`` may be a scalar or a tensor of per-device means (device-to-device
    spread); ``x0`` defaults to ``mu``.  Runs on ``device``.
    """
    dev = resolve_device(device)
    mu_ = _f32(params.vth_mu if mu is None else mu, dev)
    x0_ = mu_ if x0 is None else _f32(x0, dev)
    eps = prng.normal(key, (n,) + tuple(mu_.shape), device=dev)
    return ou_scan(eps, mu_, x0_, np.float32(params.ou_theta), np.float32(params.ou_sigma_w))


def sample_devices(key, n_devices: int, params: MemristorParams = DEFAULT_PARAMS, *,
                   device="cuda") -> torch.Tensor:
    """Per-device mean V_th values (device-to-device variation, Fig 1d)."""
    dev = resolve_device(device)
    d2d_sigma = params.vth_mu * params.d2d_cv
    eps = prng.normal(key, (n_devices,), device=dev)
    return _f32(params.vth_mu, dev) + _f32(d2d_sigma, dev) * eps


def fit_ou(path) -> Tuple[float, float, float]:
    """Least-squares AR(1) fit of an OU process: returns (theta, mu, sigma_w).

    Mirrors the paper's Fig S4 stability analysis: x_{t+1} - x_t regressed
    on x_t, in float64 on the host (a fit of one trajectory).
    """
    if isinstance(path, torch.Tensor):
        path = path.detach().cpu().numpy()
    x = np.asarray(path, dtype=np.float64)
    xt, xn = x[:-1], x[1:]
    # xn = a + b * xt + resid ; theta = 1 - b, mu = a / theta.
    b, a = np.polyfit(xt, xn, 1)
    theta = 1.0 - b
    mu = a / theta if abs(theta) > 1e-9 else float(np.mean(x))
    resid = xn - (a + b * xt)
    sigma_w = float(np.std(resid))
    return float(theta), float(mu), sigma_w


def switching_event(key, v_in, n_cycles: int, params: MemristorParams = DEFAULT_PARAMS,
                    mu=None, *, device="cuda") -> torch.Tensor:
    """Simulate ``n_cycles`` pulsed cycles: did the device switch on each pulse?

    A pulse of amplitude ``v_in`` switches the memristor iff ``v_in > V_th,t``,
    ``V_th,t`` the OU trajectory; the volatile self-reset needs no reset
    circuitry.  Returns uint8 ``(n_cycles,) + broadcast shape``.
    """
    vth = sample_ou_path(key, n_cycles, params, mu=mu, device=device)
    return (_f32(v_in, vth.device) > vth).to(torch.uint8)


def endurance_trace(key, cycles: int, params: MemristorParams = DEFAULT_PARAMS, *,
                    device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """HRS/LRS resistance readings over an endurance test (Fig 1e): log-normal
    jitter around stable means, separated by the switching ratio."""
    dev = resolve_device(device)
    k1, k2 = prng.split(key)
    lrs = _f32(1e4, dev) * torch.exp(_f32(0.05, dev) * prng.normal(k1, (cycles,), device=dev))
    # the mean in float64, rounded once: the same on every device and thread count
    hrs = lrs.double().mean().float() * _f32(params.switching_ratio, dev) * torch.exp(
        _f32(0.08, dev) * prng.normal(k2, (cycles,), device=dev))
    return hrs, lrs
