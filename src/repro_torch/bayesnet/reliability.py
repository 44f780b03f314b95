"""Decision reliability: confidence signal, retry policy, harvest statistics.

The paper's claim is *timely reliable* decision-making: the stochastic
readout must not only be fast, it must know when it has not yet accumulated
enough evidence to commit to an action.  This module derives that signal from
quantities every compiled launch already returns -- the posterior count
ratios and the accepted-sample count -- and packages the policy knobs and
bookkeeping the :class:`~repro_torch.bayesnet.driver.FrameDriver` uses to act on
it.

**Confidence.**  For one query, the MAP decision flips iff the runner-up
value out-draws the leader on a re-run.  With ``c1`` / ``c2`` accepted counts
for the top two values, the count margin is asymptotically normal with
variance ~ ``c1 + c2`` (binomial between the two leaders, conditioned on the
rest), so

    z = (c1 - c2) / sqrt(c1 + c2)

is a decision-margin z-score and ``Phi(z)`` approximates the probability the
decision survives a fresh launch.  A frame's confidence is the *minimum* over
its queries (the decision vector is only as reliable as its shakiest entry),
and exactly ``0`` where nothing was accepted -- a rejected frame carries no
evidence at all, whatever the fallback posterior says.

**Retry.**  :class:`RetryPolicy` bounds how hard the driver tries: frames
below ``min_confidence`` are re-launched with fresh entropy and an
``escalation``-times longer bitstream, at most ``max_retries`` times, never
past ``max_n_bits``.  Budget exhaustion degrades gracefully: the frame is
emitted with its best-effort posterior and ``reliable=False`` in its
:class:`FrameReport`, never dropped.

**Accounting.**  :class:`ReliabilityStats` aggregates per-harvest counters
(retries, escalation histogram, slow launches flagged by the driver's
wall-time watchdog, bit budget) so benchmarks can report retry overhead next
to flip-rate; :func:`flip_rate` scores decision stability against a
reference.

**Drift.**  :class:`DriftMonitor` watches the *slow* failure mode the retry
policy cannot see: crossbar read noise growing with endurance wear degrades
every launch a little, so per-frame confidence gating just retries more and
more while the programmed thresholds walk away from the CPTs.  The monitor
runs one :class:`~repro_torch.distributed.fault.CusumDetector` per launch-level
statistic -- mean decision confidence (drop = drift), acceptance rate
(drop), and optionally an externally supplied flip-vs-expected rate (rise)
-- and escalates a health state machine HEALTHY -> DRIFTING ->
RECALIBRATING.  RECALIBRATING latches until :meth:`DriftMonitor.reset`
(after a calibrate-back plan swap, :mod:`repro_torch.bayesnet.calibrate`).  The
whole monitor is a pure function of its observation sequence, so a seeded
chaos replay reproduces every score and state transition exactly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np

from repro_torch.distributed.fault import CusumDetector

_erf = np.vectorize(math.erf, otypes=[np.float64])

# Per-tenant crossbar health states (DriftMonitor, DESIGN.md §15): DRIFTING
# de-escalates if the statistics recover; RECALIBRATING latches until a
# calibrate-back swap resets the monitor.
HEALTH_HEALTHY = "HEALTHY"
HEALTH_DRIFTING = "DRIFTING"
HEALTH_RECALIBRATING = "RECALIBRATING"
HEALTH_STATES = (HEALTH_HEALTHY, HEALTH_DRIFTING, HEALTH_RECALIBRATING)

# Terminal frame statuses of the fleet-level serving tier
# (:class:`~repro_torch.serve.router.BayesRouter`): every submitted frame ends in
# EXACTLY one of these -- the never-drop invariant, extended from the frame
# (FrameReport.reliable) to the fleet.
STATUS_OK = "OK"                    # served at full fidelity
STATUS_DEGRADED = "DEGRADED"        # served with a downgraded n_bits plan
STATUS_UNRELIABLE = "UNRELIABLE"    # emitted below confidence / after failures
STATUS_REJECTED = "REJECTED"        # shed at admission: deadline-infeasible
TERMINAL_STATUSES = (
    STATUS_OK, STATUS_DEGRADED, STATUS_UNRELIABLE, STATUS_REJECTED,
)


def _phi(z: np.ndarray) -> np.ndarray:
    """Standard normal CDF, elementwise."""
    return 0.5 * (1.0 + _erf(np.asarray(z, np.float64) / math.sqrt(2.0)))


def top2_margin_z(post: np.ndarray, accepted: np.ndarray) -> np.ndarray:
    """Per-query decision-margin z-scores, shape ``(B, n_q)``.

    ``post`` is a compiled-network posterior batch -- ``(B, n_q)`` of
    ``P(q=1)`` for all-binary queries or ``(B, n_q, max_k)`` normalised
    per-value posteriors -- and ``accepted`` the ``(B,)`` accepted-sample
    counts.  Counts are reconstructed as ``post * accepted`` (the ratio
    estimator's posteriors are exactly count fractions), the top two values
    per query found, and ``z = (c1 - c2) / sqrt(max(c1 + c2, 1))``.
    Rows with ``accepted == 0`` get ``z = 0`` for every query.
    """
    post = np.asarray(post, np.float64)
    acc = np.asarray(accepted, np.float64)
    if post.ndim == 2:                         # binary layout: P(q=1)
        top = np.maximum(post, 1.0 - post) * acc[:, None]
        second = acc[:, None] - top
    else:                                      # k-ary layout: per-value
        counts = post * acc[:, None, None]
        counts = np.sort(counts, axis=-1)
        top, second = counts[..., -1], counts[..., -2]
    z = (top - second) / np.sqrt(np.maximum(top + second, 1.0))
    return np.where(acc[:, None] > 0, z, 0.0)


def decision_confidence(post: np.ndarray, accepted: np.ndarray) -> np.ndarray:
    """Frame-level decision confidence in ``[0, 1]``, shape ``(B,)``.

    ``Phi`` of the *minimum* per-query margin z-score (module docstring);
    exactly ``0.0`` where ``accepted == 0``.
    """
    z = top2_margin_z(post, accepted)
    conf = _phi(np.min(z, axis=-1))
    return np.where(np.asarray(accepted) > 0, conf, 0.0)


def flip_rate(decisions: np.ndarray, reference: np.ndarray) -> float:
    """Fraction of per-query MAP decisions that differ from ``reference``.

    Both arguments are ``(B, n_q)`` integer decision arrays (e.g. from
    :meth:`CompiledNetwork.decide` under different noise / entropy); the
    rate is elementwise over all ``B * n_q`` decisions.
    """
    d = np.asarray(decisions)
    r = np.asarray(reference)
    if d.shape != r.shape:
        raise ValueError(f"decision shapes differ: {d.shape} vs {r.shape}")
    if d.size == 0:
        return 0.0
    return float(np.mean(d != r))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded confidence-gated retry (driver knob, see module docstring).

    ``min_confidence``: emit without retry at or above this.  ``max_retries``:
    re-launch budget per frame (attempts = 1 + retries).  ``escalation``:
    n_bits multiplier per attempt (exponential -- a retry that was noise-bound
    needs materially more evidence, not another coin flip at the same
    length).  ``max_n_bits``: hard ceiling on any single attempt's stream
    length (compile-size guard).
    """

    min_confidence: float = 0.9
    max_retries: int = 2
    escalation: int = 2
    max_n_bits: int = 1 << 17

    def __post_init__(self):
        if not 0.0 <= self.min_confidence <= 1.0:
            raise ValueError(
                f"min_confidence must be in [0, 1], got {self.min_confidence}"
            )
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.escalation < 1:
            raise ValueError(f"escalation must be >= 1, got {self.escalation}")
        if self.max_n_bits < 32 or self.max_n_bits % 32:
            raise ValueError(
                f"max_n_bits must be a positive multiple of 32, got {self.max_n_bits}"
            )

    def n_bits_for(self, base_n_bits: int, attempt: int) -> int:
        """Stream length of attempt ``attempt`` (0-based), capped and 32-aligned."""
        n = min(int(base_n_bits) * self.escalation**int(attempt), self.max_n_bits)
        return max(32, (n // 32) * 32)


@dataclasses.dataclass(frozen=True)
class FrameReport:
    """Per-frame reliability verdict attached by the retrying driver.

    ``attempts`` counts launches this frame rode (1 = no retry); ``n_bits``
    is the final attempt's stream length, ``total_bits`` the sum over all
    attempts (the frame's whole entropy bill).  ``reliable`` is False only
    when the retry budget ran out below ``min_confidence`` -- the posterior
    is still the best-effort final attempt, never dropped.

    ``escalation_clamped`` flags the retry/degradation collision: the frame's
    escalation schedule asked for more bits than its (degraded) driver's
    ceiling allows, so an attempt ran shorter than the policy's nominal
    ladder -- the serve router clamps ``max_n_bits`` to the tenant's current
    rung rather than silently re-inflating a degraded tenant's launch cost.
    """

    confidence: float
    attempts: int
    n_bits: int
    total_bits: int
    reliable: bool
    escalation_clamped: bool = False


@dataclasses.dataclass
class ReliabilityStats:
    """Mutable per-driver (or per-harvest) reliability accounting.

    ``escalations`` maps final attempt index (0-based) to frames that
    finished there -- ``{0: N}`` means no frame ever retried.  ``merge``
    folds another instance in (shard / multi-driver aggregation).
    """

    frames: int = 0
    launches: int = 0
    retries: int = 0
    unreliable: int = 0
    slow_launches: int = 0
    launch_failures: int = 0
    total_bits: int = 0
    confidence_sum: float = 0.0
    min_confidence: Optional[float] = None
    escalations: Dict[int, int] = dataclasses.field(default_factory=dict)

    def record_frame(
        self, confidence: float, final_attempt: int, total_bits: int, reliable: bool
    ) -> None:
        self.frames += 1
        self.retries += int(final_attempt)
        self.unreliable += int(not reliable)
        self.total_bits += int(total_bits)
        self.confidence_sum += float(confidence)
        self.min_confidence = (
            float(confidence) if self.min_confidence is None
            else min(self.min_confidence, float(confidence))
        )
        self.escalations[int(final_attempt)] = (
            self.escalations.get(int(final_attempt), 0) + 1
        )

    @property
    def mean_confidence(self) -> float:
        return self.confidence_sum / self.frames if self.frames else 0.0

    @property
    def mean_bits(self) -> float:
        """Mean entropy bill per emitted frame (retry overhead axis)."""
        return self.total_bits / self.frames if self.frames else 0.0

    @property
    def retry_rate(self) -> float:
        return self.retries / self.frames if self.frames else 0.0

    def merge(self, other: "ReliabilityStats") -> None:
        self.frames += other.frames
        self.launches += other.launches
        self.retries += other.retries
        self.unreliable += other.unreliable
        self.slow_launches += other.slow_launches
        self.launch_failures += other.launch_failures
        self.total_bits += other.total_bits
        self.confidence_sum += other.confidence_sum
        if other.min_confidence is not None:
            self.min_confidence = (
                other.min_confidence if self.min_confidence is None
                else min(self.min_confidence, other.min_confidence)
            )
        for k, v in other.escalations.items():
            self.escalations[k] = self.escalations.get(k, 0) + v

    def as_dict(self) -> Dict[str, float]:
        """Flat JSON-friendly snapshot for bench emission."""
        return {
            "frames": self.frames,
            "launches": self.launches,
            "retries": self.retries,
            "retry_rate": self.retry_rate,
            "unreliable": self.unreliable,
            "slow_launches": self.slow_launches,
            "launch_failures": self.launch_failures,
            "mean_bits": self.mean_bits,
            "mean_confidence": self.mean_confidence,
            "min_confidence": (
                self.min_confidence if self.min_confidence is not None else 0.0
            ),
            "escalations": {str(k): v for k, v in sorted(self.escalations.items())},
        }


@dataclasses.dataclass(frozen=True)
class DriftPolicy:
    """Knobs of the online drift detector (see module docstring).

    ``warmup`` launches establish each statistic's baseline (a fresh or
    freshly recalibrated array defines "healthy"); ``cusum_k`` is the CUSUM
    slack in baseline sigmas (sub-``k``-sigma wander decays, sustained
    larger shifts accumulate ~linearly); ``drift_h`` / ``recal_h`` are the
    score thresholds for the DRIFTING flag and the RECALIBRATING latch --
    with a sustained ``s``-sigma shift the monitor escalates after roughly
    ``recal_h / (s - cusum_k)`` launches, so the defaults trip on a 2-sigma
    drift within ~5 launches while one noisy launch (bounded score gain)
    never can.
    """

    warmup: int = 8
    cusum_k: float = 0.5
    drift_h: float = 3.0
    recal_h: float = 8.0
    min_std: float = 1e-3
    ewma_alpha: float = 0.2

    def __post_init__(self):
        if self.warmup < 1:
            raise ValueError(f"warmup must be >= 1, got {self.warmup}")
        if self.drift_h <= 0 or self.recal_h < self.drift_h:
            raise ValueError(
                f"need 0 < drift_h <= recal_h, got {self.drift_h}/{self.recal_h}"
            )
        if self.cusum_k < 0:
            raise ValueError(f"cusum_k must be >= 0, got {self.cusum_k}")


#: statistic name -> CUSUM direction (+1 alarms on rise, -1 on drop)
DRIFT_STATISTICS = {"confidence": -1, "accept_rate": -1, "flip": 1}


class DriftMonitor:
    """Online crossbar-health monitor over per-launch statistics.

    One :class:`~repro_torch.distributed.fault.CusumDetector` per statistic of
    :data:`DRIFT_STATISTICS`; the health state is driven by the *peak*
    detector score: ``>= recal_h`` latches RECALIBRATING (cleared only by
    :meth:`reset`, i.e. an actual calibrate-back swap), ``>= drift_h`` flags
    DRIFTING, and a DRIFTING flag de-escalates if the scores decay back
    below ``drift_h``.  The driver feeds ``confidence`` / ``accept_rate``
    per harvested launch (:class:`~repro_torch.bayesnet.driver.FrameDriver`
    ``drift=``); the flip detector is fed by callers that hold a reference
    decision stream (:meth:`observe_flip`), since a live harvest has no
    oracle.  ``metrics`` routes scores/state into a
    :class:`~repro_torch.obs.MetricsRegistry` (gauges ``drift_score_<stat>`` and
    ``drift_state``, counters ``drift_launches`` / ``drift_alarms``),
    prefixed with ``<name>_`` when a tenant name is given.
    """

    def __init__(self, policy: DriftPolicy | None = None, metrics=None,
                 name: str | None = None):
        self.policy = policy if policy is not None else DriftPolicy()
        if not isinstance(self.policy, DriftPolicy):
            raise TypeError(f"policy must be a DriftPolicy, got {type(policy)!r}")
        self.metrics = metrics
        self.name = name
        p = self.policy
        self.detectors = {
            stat: CusumDetector(
                k=p.cusum_k, direction=direction, warmup=p.warmup,
                min_std=p.min_std, alpha=p.ewma_alpha,
            )
            for stat, direction in DRIFT_STATISTICS.items()
        }
        self.state = HEALTH_HEALTHY
        self.launches = 0
        self.alarms = 0
        self.resets = 0

    def _prefix(self, key: str) -> str:
        return f"{self.name}_{key}" if self.name else key

    def observe_launch(
        self, confidence: float, accept_rate: float,
        flip: float | None = None,
    ) -> str:
        """Fold one harvested launch's statistics; returns the health state."""
        self.launches += 1
        self.detectors["confidence"].observe(confidence)
        self.detectors["accept_rate"].observe(accept_rate)
        if flip is not None:
            self.detectors["flip"].observe(flip)
        if self.metrics is not None:
            self.metrics.inc(self._prefix("drift_launches"))
        return self._update_state()

    def observe_flip(self, flip: float) -> str:
        """Fold one flip-vs-expected observation (caller-supplied reference)."""
        self.detectors["flip"].observe(flip)
        return self._update_state()

    def _update_state(self) -> str:
        peak = self.peak_score
        if self.state != HEALTH_RECALIBRATING:
            if peak >= self.policy.recal_h:
                self.state = HEALTH_RECALIBRATING
                self.alarms += 1
            elif peak >= self.policy.drift_h:
                if self.state != HEALTH_DRIFTING:
                    self.alarms += 1
                self.state = HEALTH_DRIFTING
            else:
                self.state = HEALTH_HEALTHY
        if self.metrics is not None:
            for stat, det in self.detectors.items():
                self.metrics.set_gauge(
                    self._prefix(f"drift_score_{stat}"), det.score
                )
            self.metrics.set_gauge(
                self._prefix("drift_state"), float(HEALTH_STATES.index(self.state))
            )
            if self.state != HEALTH_HEALTHY:
                self.metrics.inc(self._prefix("drift_alarms"))
        return self.state

    @property
    def peak_score(self) -> float:
        return max(det.score for det in self.detectors.values())

    def reset(self, full: bool = False) -> None:
        """Clear the RECALIBRATING latch after a calibrate-back plan swap.

        ``full=True`` also discards the warmup baselines, so the freshly
        swapped plan defines a new "healthy" operating point (use when the
        recalibration changes the expected statistics, e.g. a different
        n_bits rung).
        """
        for det in self.detectors.values():
            det.reset(keep_baseline=not full)
        self.state = HEALTH_HEALTHY
        self.resets += 1
        if self.metrics is not None:
            self.metrics.inc(self._prefix("drift_resets"))
            self.metrics.set_gauge(self._prefix("drift_state"), 0.0)

    def as_dict(self) -> Dict[str, float]:
        """Flat JSON-friendly snapshot for bench emission."""
        out = {
            "state": self.state,
            "launches": self.launches,
            "alarms": self.alarms,
            "resets": self.resets,
            "peak_score": self.peak_score,
        }
        for stat, det in self.detectors.items():
            out[f"score_{stat}"] = det.score
            out[f"ewma_{stat}"] = det.ewma if det.ewma is not None else 0.0
        return out
