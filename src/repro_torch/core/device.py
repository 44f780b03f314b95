"""Volatile memristor device model calibrated to the paper's measurements.

Fig 1 / S2 / S4 of the paper characterise solution-processed hBN filamentary
memristors:

* cycle-to-cycle threshold voltage  V_th  ~ N(2.08 V, 0.28 V)
* cycle-to-cycle hold voltage       V_hold~ N(0.98 V, 0.30 V)
* per-cycle V_th trajectory follows an Ornstein-Uhlenbeck (mean-reverting) process
* device-to-device coefficient of variation in V_th ~ 8 %
* switching time ~50 ns, relaxation ~1,100 ns (< 4 us per encoded bit),
  switching energy ~0.16 nJ, endurance > 1e6 cycles.

Only the calibrated constants are ported so far: the crossbar noise model
(:mod:`repro_torch.bayesnet.noise`) derives its read and wear terms from them.
The trajectory simulators (OU paths, device sampling, endurance traces) are
still to be ported (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
import numpy as np


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
