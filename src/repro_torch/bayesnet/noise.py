"""Crossbar non-ideality model: plan-build-time perturbation of DAC thresholds.

The compiled networks are mathematically exact today: every CPT row becomes
its 8-bit cumulative DAC thresholds and the comparator fires on *exactly*
those integers.  The physical crossbar does not work like that -- each
threshold is a programmed conductance read through a resistive line, and the
paper's own device characterisation (:mod:`repro_torch.core.device`) quantifies how
far reality sits from the integer grid.  This module makes that spread a
first-class compile input: a :class:`NoiseModel` deterministically perturbs
the integer CDF thresholds of every (node, CPT row, level) "device" at
plan-build time, so the SAME perturbed network flows into the fused
``net_sweep`` plan, the unfused per-node lowering, and the enumeration oracle
(:func:`repro_torch.bayesnet.analytic.make_posterior_fn` with ``noise=``) -- which
keeps 3-sigma agreement tests exact under noise.

Four non-ideality terms, applied in the conductance (multiplicative) domain
then snapped back to the integer grid:

* **device-to-device spread** -- lognormal conductance factor with CV
  ``d2d_cv`` (paper Fig 1d: ~8 %), seeded per device from the model's
  ``seed``; the factor is a property of the *device*, so it does not change
  with ``cycle``.
* **cycle-to-cycle read noise** -- lognormal factor with CV ``read_cv``
  (derived in :class:`~repro_torch.core.device.MemristorParams.read_cv` from the
  paper's V_th trajectory: stationary CV attenuated by the ~80 switching
  cycles one encoded bit integrates).  Seeded per (device, ``cycle``): the
  perturbation is a *frozen snapshot* of one read epoch, which is what lets
  the oracle twin enumerate the perturbed network exactly; re-draw with
  :meth:`NoiseModel.with_cycle` to model drift across launches.
* **line-resistance IR drop** -- deterministic position-dependent droop: the
  further a device sits along the word/bit lines, the more of the programming
  voltage the line eats, scaling its effective threshold down by up to
  ``ir_drop`` at the far corner of the array (node index = wordline, flat
  row x level index = bitline).
* **stuck-at faults** -- with probability ``p_stuck_on`` / ``p_stuck_off``
  per device, the threshold pins to 256 (always fires) / 0 (never fires),
  the endurance-tail failure mode (paper: > 1e6 cycles, so the nominal
  budget is small but non-zero).

All randomness comes from a dependency-free numpy lowbias32 hash keyed by
``(seed, cycle, crc32(node name), device index)`` -- no global RNG state, no
tracing, bit-stable across platforms -- and node identity is the node
*name*, so the same device draws the same fault regardless of which path
(fused plan, unfused streams, oracle) asks.  Perturbed rows are re-clipped to
``[0, 256]`` and re-monotonised (non-increasing cummin) so they remain valid
CDF rows for the bit-sliced comparator.

``NoiseModel()`` is the paper-nominal model; ``NoiseModel.zero()`` (or
``scaled(0.0)``) perturbs nothing and returns the clean thresholds exactly.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Dict, Tuple

import numpy as np

from repro_torch.bayesnet.spec import NetworkSpec
from repro_torch.core import rng
from repro_torch.core.device import DEFAULT_PARAMS, MemristorParams, wear_scale

_U32 = np.uint32


def _lowbias32(x: np.ndarray) -> np.ndarray:
    """Full-avalanche 32-bit hash (numpy twin of :func:`repro_torch.core.rng._lowbias32`)."""
    x = x.astype(np.uint32, copy=True)
    with np.errstate(over="ignore"):
        x ^= x >> _U32(16)
        x *= _U32(0x7FEB352D)
        x ^= x >> _U32(15)
        x *= _U32(0x846CA68B)
        x ^= x >> _U32(16)
    return x


def _fold(*words: int) -> int:
    """Chain ints into one 32-bit key (order-sensitive, avalanche per step)."""
    h = np.zeros((), np.uint32)
    for w in words:
        h = _lowbias32(h ^ _U32(w & 0xFFFFFFFF))[()]
    return int(h)


def _uniforms(key: int, counters: np.ndarray) -> np.ndarray:
    """Deterministic uniform(0, 1) draws, one per counter (never exactly 0)."""
    h = _lowbias32(counters.astype(np.uint32) ^ _U32(key & 0xFFFFFFFF))
    return (h.astype(np.float64) + 0.5) / 2.0**32


def _normals(key: int, counters: np.ndarray) -> np.ndarray:
    """Deterministic standard normals via Box-Muller over two hashed streams."""
    u1 = _uniforms(key, counters)
    u2 = _uniforms(key ^ 0x9E3779B9, counters)
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)


@dataclasses.dataclass(frozen=True)
class NoiseModel:
    """Deterministic crossbar non-ideality model (hashable compile input).

    Defaults are the paper-calibrated nominal values: ``d2d_cv`` comes
    straight from :data:`~repro_torch.core.device.DEFAULT_PARAMS` (the 8 %
    device-to-device V_th CV of Fig 1d) and ``read_cv`` from its derived
    per-read attenuation -- a test pins both so the calibration cannot
    silently drift from the device model.  ``seed`` selects the fabricated
    array instance (which devices are weak/stuck); ``cycle`` selects the
    read-noise epoch within that instance.
    """

    d2d_cv: float = DEFAULT_PARAMS.d2d_cv
    read_cv: float = DEFAULT_PARAMS.read_cv
    ir_drop: float = 0.02
    p_stuck_on: float = 5e-4
    p_stuck_off: float = 5e-4
    seed: int = 0
    cycle: int = 0
    # Endurance-wear time constant in read epochs: the effective read CV at
    # epoch c is read_cv * wear_scale(c, wear_tau) -- derived, not ad hoc
    # (:attr:`~repro_torch.core.device.MemristorParams.wear_tau_epochs`).
    wear_tau: float = DEFAULT_PARAMS.wear_tau_epochs

    def __post_init__(self):
        for f in ("d2d_cv", "read_cv", "ir_drop", "p_stuck_on", "p_stuck_off"):
            v = float(getattr(self, f))
            if not 0.0 <= v or not math.isfinite(v):
                raise ValueError(f"NoiseModel.{f} must be finite and >= 0, got {v}")
            object.__setattr__(self, f, v)
        if self.ir_drop >= 1.0:
            raise ValueError(f"ir_drop {self.ir_drop} >= 1 inverts thresholds")
        if self.p_stuck_on + self.p_stuck_off > 1.0:
            raise ValueError("p_stuck_on + p_stuck_off > 1")
        wt = float(self.wear_tau)
        if not wt > 0.0 or not math.isfinite(wt):
            raise ValueError(f"NoiseModel.wear_tau must be finite and > 0, got {wt}")
        object.__setattr__(self, "wear_tau", wt)
        object.__setattr__(self, "seed", int(self.seed))
        object.__setattr__(self, "cycle", int(self.cycle))

    # ---------------------------------------------------------- constructors
    @classmethod
    def nominal(
        cls, params: MemristorParams = DEFAULT_PARAMS, seed: int = 0, cycle: int = 0
    ) -> "NoiseModel":
        """Paper-calibrated model from a device-parameter set."""
        return cls(d2d_cv=params.d2d_cv, read_cv=params.read_cv,
                   seed=seed, cycle=cycle, wear_tau=params.wear_tau_epochs)

    @classmethod
    def zero(cls, seed: int = 0) -> "NoiseModel":
        """The identity model: perturbs nothing, thresholds stay exact."""
        return cls(d2d_cv=0.0, read_cv=0.0, ir_drop=0.0,
                   p_stuck_on=0.0, p_stuck_off=0.0, seed=seed)

    def scaled(self, m: float) -> "NoiseModel":
        """Every non-ideality magnitude scaled by ``m`` (sweep axis helper)."""
        m = float(m)
        return dataclasses.replace(
            self, d2d_cv=self.d2d_cv * m, read_cv=self.read_cv * m,
            ir_drop=self.ir_drop * m, p_stuck_on=self.p_stuck_on * m,
            p_stuck_off=self.p_stuck_off * m,
        )

    def with_cycle(self, cycle: int) -> "NoiseModel":
        """Same array instance, fresh read-noise epoch (d2d/stuck unchanged)."""
        return dataclasses.replace(self, cycle=int(cycle))

    @property
    def is_zero(self) -> bool:
        return (self.d2d_cv == 0.0 and self.read_cv == 0.0 and self.ir_drop == 0.0
                and self.p_stuck_on == 0.0 and self.p_stuck_off == 0.0)

    def read_cv_at(self, cycle: int | None = None) -> float:
        """Effective read CV at ``cycle`` (default: this model's own cycle).

        The calibrated fresh-device ``read_cv`` grows with endurance wear as
        ``wear_scale(cycle, wear_tau)`` (:mod:`repro_torch.core.device`): exactly
        ``read_cv`` at cycle 0, doubling in variance every ``wear_tau``
        epochs.  This is the only cycle-dependent *magnitude* in the model --
        the d2d spread, IR droop, and stuck map are properties of the array,
        not of the epoch.
        """
        c = self.cycle if cycle is None else int(cycle)
        return self.read_cv * wear_scale(c, self.wear_tau)

    # ------------------------------------------------------------ perturbation
    def error_factors(
        self, name: str, l: int, k1: int, node_pos: int, n_nodes: int
    ) -> np.ndarray:
        """The ``(l, k1)`` multiplicative conductance error of one node's array.

        The deterministic part of the perturbation -- d2d lognormal x
        wear-scaled read lognormal x IR droop -- BEFORE grid rounding, stuck
        faults, and re-monotonisation.  Exposed separately so calibrate-back
        (:mod:`repro_torch.bayesnet.calibrate`) can divide it out of the programmed
        thresholds: ``perturb_rows(rows / factors) ~ rows`` up to one DAC step
        plus the stuck devices nothing can compensate.
        """
        f = np.ones((l, k1), np.float64)
        if l * k1 == 0:
            return f
        dev = np.arange(l * k1, dtype=np.uint32).reshape(l, k1)
        nh = zlib.crc32(name.encode("utf-8"))
        if self.d2d_cv > 0.0:
            sg = math.sqrt(math.log1p(self.d2d_cv**2))
            dev_key = _fold(self.seed, nh, 0x0D2D)
            f = f * np.exp(sg * _normals(dev_key, dev) - 0.5 * sg * sg)
        rc = self.read_cv_at()
        if rc > 0.0:
            sr = math.sqrt(math.log1p(rc**2))
            read_key = _fold(self.seed, nh, 0x0C2C, self.cycle)
            f = f * np.exp(sr * _normals(read_key, dev) - 0.5 * sr * sr)
        if self.ir_drop > 0.0:
            # Word/bit-line voltage divider: devices further down either line
            # see less of the programming voltage; linear droop per axis,
            # worst case (far corner) = 1 - ir_drop.
            word = (node_pos + 1) / max(n_nodes, 1)
            bit = (dev.astype(np.float64) + 1.0) / float(l * k1)
            f = f * (1.0 - self.ir_drop * 0.5 * (word + bit))
        return f

    def perturb_rows(
        self,
        name: str,
        clean_rows: Tuple[Tuple[int, ...], ...],
        node_pos: int,
        n_nodes: int,
    ) -> Tuple[Tuple[int, ...], ...]:
        """Perturb one node's integer CDF rows; returns valid CDF rows.

        ``clean_rows``: ``(L, card-1)`` cumulative thresholds in ``[0, 256]``
        (:func:`repro_torch.core.rng.cdf_thresholds_int` output).  Each threshold is
        one physical device at wordline ``node_pos`` (of ``n_nodes``) and
        bitline ``row * (card-1) + level``; its perturbed value is a pure
        function of ``(seed, cycle, name, device index)``.
        """
        t = np.asarray(clean_rows, np.float64)
        if t.size == 0:
            return tuple(tuple(r) for r in clean_rows)
        if self.is_zero:
            return tuple(tuple(int(x) for x in row) for row in clean_rows)
        l, k1 = t.shape
        out = t * self.error_factors(name, l, k1, node_pos, n_nodes)
        out = np.clip(np.rint(out), 0.0, 256.0)
        if self.p_stuck_on > 0.0 or self.p_stuck_off > 0.0:
            dev = np.arange(l * k1, dtype=np.uint32).reshape(l, k1)
            stuck_key = _fold(self.seed, zlib.crc32(name.encode("utf-8")), 0x057C)
            u = _uniforms(stuck_key, dev)
            out = np.where(u < self.p_stuck_on, 256.0, out)
            out = np.where(
                (u >= self.p_stuck_on) & (u < self.p_stuck_on + self.p_stuck_off),
                0.0, out,
            )
        # Re-monotonise: cumulative tails must be non-increasing for the
        # nested comparator chains (a stuck-on device saturates every deeper
        # level's ceiling; a stuck-off one floors the shallower levels' tail).
        out = np.minimum.accumulate(out, axis=1)
        return tuple(tuple(int(x) for x in row) for row in out)


def _sanitize_rows(rows) -> Tuple[Tuple[int, ...], ...]:
    """Clip to the DAC grid and re-monotonise programmed rows (no noise)."""
    t = np.asarray(rows, np.float64)
    if t.size == 0:
        return tuple(tuple(int(x) for x in r) for r in rows)
    t = np.minimum.accumulate(np.clip(np.rint(t), 0.0, 256.0), axis=1)
    return tuple(tuple(int(x) for x in row) for row in t)


def perturbed_cdf_rows(
    spec: NetworkSpec,
    noise: NoiseModel | None,
    program: Dict[str, Tuple[Tuple[int, ...], ...]] | None = None,
) -> Dict[str, Tuple[Tuple[int, ...], ...]]:
    """Perturbed integer CDF rows for every node of ``spec``, keyed by name.

    The single source of truth consumed by all three backends: the fused
    :func:`~repro_torch.bayesnet.compile.sweep_plan`, the unfused
    :func:`~repro_torch.bayesnet.compile.lower_streams`, and the oracle twin
    (:func:`~repro_torch.bayesnet.analytic.make_posterior_fn` with ``noise=``).
    Wordline positions follow topological order (the fused plan's node
    numbering), but the random draws key on the node *name*, so any caller
    iterating in any order sees the identical perturbed array.

    ``program`` optionally overrides the *programmed* thresholds of named
    nodes before perturbation -- the calibrate-back hook: a compensated
    program divides the deterministic error factors out so the perturbed
    array lands back on the intended grid.  Nodes absent from ``program``
    use the clean spec thresholds; with ``noise=None`` the programmed rows
    are returned as-is (clipped / re-monotonised).
    """
    order = spec.topo_order()
    out: Dict[str, Tuple[Tuple[int, ...], ...]] = {}
    for pos, name in enumerate(order):
        if program is not None and name in program:
            base = tuple(tuple(int(t) for t in r) for r in program[name])
        else:
            base = tuple(rng.cdf_thresholds_int(r) for r in spec.cpt_rows(name))
        if noise is None:
            out[name] = _sanitize_rows(base)
        else:
            out[name] = noise.perturb_rows(name, base, pos, len(order))
    return out
