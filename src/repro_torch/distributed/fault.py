"""Fault tolerance: preemption checkpointing, straggler watch, loss-spike
rewind, and seeded launch-level chaos injection.

Mechanisms (exercised by tests/train/test_fault_ckpt.py,
tests/distributed/test_straggler_warmup.py and the serving fault tests;
``StragglerWatch`` doubles as the bayesnet
:class:`~repro_torch.bayesnet.driver.FrameDriver`'s launch-latency watchdog):

* ``PreemptionGuard`` -- SIGTERM/SIGINT sets a flag; the train loop checkpoints
  and exits cleanly at the next step boundary (standard TPU preemption flow).
* ``StragglerWatch``  -- wall-time EWMA per step; steps slower than
  ``threshold x`` the EWMA are flagged.  On a real fleet the runbook is: flag ->
  blocklist node -> restart from the last committed checkpoint with the elastic
  restore path (checkpoint/ckpt.py) on the surviving N-1 hosts.  Here the
  detection + the elastic-restore mechanics are what we can execute.
* ``SpikeRewind``     -- divergence guard: if loss exceeds ``factor x`` its EWMA
  for ``patience`` consecutive steps, signal a rewind to the last checkpoint
  (bad-node/bad-batch recovery at scale).
* ``LaunchFaultInjector`` -- seeded, rate-configurable chaos hook for the
  serving path: each launch draws a deterministic verdict (``None`` /
  ``"drop"`` / ``"stall"`` / ``"corrupt"``) from a counter-keyed PRNG, so a
  chaos run replays bit-for-bit and CI can gate the never-drop invariant
  under a fixed fault schedule.
"""

from __future__ import annotations

import signal
import time
from typing import Dict, Optional

import numpy as np


class PreemptionGuard:
    def __init__(self, install: bool = True):
        self.requested = False
        self._prev = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:   # non-main thread (tests)
                    pass

    def _handler(self, signum, frame):
        self.requested = True

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


class StragglerWatch:
    """Wall-time EWMA straggler detector.

    ``metrics`` (a :class:`~repro_torch.obs.metrics.MetricsRegistry`) is optional:
    when set, every observed interval lands in the ``watch_step_ms``
    histogram and the ``watch_steps`` / ``watch_slow_steps`` counters, so the
    watchdog's verdicts are queryable next to the rest of the serving
    telemetry instead of living only in ``flagged_steps``.

    ``warmup_steps`` fixes the slow-first-step bug: the EWMA used to be
    seeded by the very first observation, so a slow first step (a jit
    compile, a cold cache) inflated the baseline by orders of magnitude and
    masked every later straggler until the EWMA decayed.  The first
    ``warmup_steps`` observations are never flagged and only collected; the
    EWMA is then seeded with their *mean*, so one cold outlier is averaged
    against the warm steps instead of becoming the baseline.
    ``warmup_steps=1`` is exactly the legacy behaviour (the first
    observation seeds the EWMA and is never flagged).

    ``min_dt`` tracks the fastest *steady-state* interval: the minimum over
    post-seed, non-flagged observations.  Warmup/seed observations (where a
    jit compile hides) and flagged stragglers are excluded, so it converges
    to the genuine capability floor of the step being watched -- the serve
    router uses it as an optimistic launch-time estimate for deadline
    admission (shed only what even a best-case launch cannot serve in time;
    an EWMA contaminated by one compile would shed everything forever).
    """

    def __init__(
        self,
        threshold: float = 3.0,
        alpha: float = 0.2,
        metrics=None,
        warmup_steps: int = 1,
    ):
        if warmup_steps < 1:
            raise ValueError(f"warmup_steps must be >= 1, got {warmup_steps}")
        self.threshold = threshold
        self.alpha = alpha
        self.metrics = metrics
        self.warmup_steps = int(warmup_steps)
        self.ewma: Optional[float] = None
        self.min_dt: Optional[float] = None
        self.flagged_steps: list[int] = []
        self._t0: Optional[float] = None
        self._warmup: list[float] = []

    def step_start(self):
        self._t0 = time.monotonic()

    def step_end(self, step: int) -> bool:
        # An un-started watch used to measure `now - now` and report a silent
        # 0.0 -- which then poisoned the EWMA toward zero and flagged every
        # real step as a straggler.  A missing step_start is a caller bug;
        # say so instead of fabricating a timing.
        if self._t0 is None:
            raise RuntimeError(
                "StragglerWatch.step_end() without a matching step_start(); "
                "an un-started watch has no interval to measure"
            )
        dt = time.monotonic() - self._t0
        self._t0 = None
        return self.observe(step, dt)

    def observe(self, step: int, dt: float) -> bool:
        """Record one interval directly (the timer-free entry point)."""
        if self.ewma is None:
            # warmup: collect without flagging, mean-seed once full
            self._warmup.append(dt)
            slow = False
            if len(self._warmup) >= self.warmup_steps:
                self.ewma = sum(self._warmup) / len(self._warmup)
                self._warmup = []
        elif dt > self.threshold * self.ewma:
            slow = True
            self.flagged_steps.append(step)
        else:
            # EWMA excludes flagged outliers so one straggler doesn't mask
            # the next
            slow = False
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
            self.min_dt = dt if self.min_dt is None else min(self.min_dt, dt)
        if self.metrics is not None:
            self.metrics.inc("watch_steps")
            if slow:
                self.metrics.inc("watch_slow_steps")
            self.metrics.observe("watch_step_ms", dt * 1e3)
        return slow


class CusumDetector:
    """One-sided CUSUM over a streaming statistic, with a warmup baseline.

    The classic change-point accumulator: the first ``warmup`` observations
    fix a baseline mean/std (never alarmed on), after which each observation
    is standardised, oriented (``direction=+1`` accumulates upward shifts,
    ``-1`` downward), and folded as ``S = max(0, S + z * direction - k)``.
    ``k`` is the slack in baseline sigmas -- drifts smaller than ``k`` decay
    back to zero, sustained larger shifts grow ``S`` linearly -- so callers
    compare :attr:`score` against their own thresholds (the
    :class:`~repro_torch.bayesnet.reliability.DriftMonitor` uses two: alarm and
    escalate).  An :attr:`ewma` of the raw statistic rides along for
    telemetry.  The whole state is a pure function of the observation
    sequence -- no clocks, no RNG -- so a seeded chaos replay reproduces
    every score and alarm bit-for-bit.
    """

    def __init__(
        self,
        k: float = 0.5,
        direction: int = 1,
        warmup: int = 8,
        min_std: float = 1e-3,
        alpha: float = 0.2,
    ):
        if warmup < 1:
            raise ValueError(f"warmup must be >= 1, got {warmup}")
        if direction not in (1, -1):
            raise ValueError(f"direction must be +1 or -1, got {direction}")
        self.k = float(k)
        self.direction = int(direction)
        self.warmup = int(warmup)
        self.min_std = float(min_std)
        self.alpha = float(alpha)
        self.score = 0.0
        self.ewma: Optional[float] = None
        self.n = 0
        self.baseline_mean: Optional[float] = None
        self.baseline_std: Optional[float] = None
        self._warm: list[float] = []

    def observe(self, x: float) -> float:
        """Fold one observation; returns the updated CUSUM score."""
        x = float(x)
        self.n += 1
        self.ewma = x if self.ewma is None else (
            (1 - self.alpha) * self.ewma + self.alpha * x
        )
        if self.baseline_mean is None:
            self._warm.append(x)
            if len(self._warm) >= self.warmup:
                self.baseline_mean = float(np.mean(self._warm))
                self.baseline_std = max(float(np.std(self._warm)), self.min_std)
                self._warm = []
            return self.score
        z = (x - self.baseline_mean) / self.baseline_std
        self.score = max(0.0, self.score + z * self.direction - self.k)
        return self.score

    def reset(self, keep_baseline: bool = True) -> None:
        """Zero the accumulator; optionally restart the warmup baseline too."""
        self.score = 0.0
        if not keep_baseline:
            self.baseline_mean = None
            self.baseline_std = None
            self.ewma = None
            self.n = 0
            self._warm = []


#: fault kinds a :class:`LaunchFaultInjector` can inject, in draw order
LAUNCH_FAULTS = ("drop", "stall", "corrupt")


class LaunchFaultInjector:
    """Seeded launch-level chaos: deterministic drop/stall/corrupt verdicts.

    The serving layers ask ``draw(*ids)`` once per launch (the driver passes
    its ``(salt, ticket)`` pair) and receive ``None`` or one of
    ``LAUNCH_FAULTS``:

    * ``"drop"``    -- the launch never runs; its results never arrive
      (harvest raises :class:`LaunchFault`, the driver's recovery path
      re-enqueues the frames).
    * ``"stall"``   -- injected host-side latency of ``stall_ms`` before the
      dispatch completes, sized to trip the :class:`StragglerWatch`
      threshold (the launch itself still succeeds).
    * ``"corrupt"`` -- the harvested posterior buffer is overwritten with
      NaNs, so the driver's harvest validation must catch it (a silent
      pass-through would hand a poisoned posterior to the caller).

    Verdicts come from a PRNG keyed by ``(seed, *ids)`` -- NOT from shared
    stream state -- so the schedule is a pure function of the launch
    identity: two drivers sharing one injector cannot perturb each other's
    fault schedules, and a replay with the same salts sees the same faults.
    ``injected`` counts verdicts by kind for reporting.
    """

    def __init__(
        self,
        seed: int = 0,
        p_drop: float = 0.0,
        p_stall: float = 0.0,
        p_corrupt: float = 0.0,
        stall_ms: float = 20.0,
    ):
        for name, p in (("p_drop", p_drop), ("p_stall", p_stall),
                        ("p_corrupt", p_corrupt)):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if p_drop + p_stall + p_corrupt > 1.0:
            raise ValueError(
                f"fault rates must sum to <= 1, got "
                f"{p_drop + p_stall + p_corrupt}"
            )
        self.seed = int(seed)
        self.p_drop = float(p_drop)
        self.p_stall = float(p_stall)
        self.p_corrupt = float(p_corrupt)
        self.stall_ms = float(stall_ms)
        self.injected: Dict[str, int] = {k: 0 for k in LAUNCH_FAULTS}

    def draw(self, *ids: int) -> Optional[str]:
        """Fault verdict for one launch identity; counts what it injects."""
        u = float(
            np.random.Generator(
                np.random.PCG64([self.seed, *(int(i) & 0xFFFFFFFF for i in ids)])
            ).random()
        )
        edge = 0.0
        for kind, p in (("drop", self.p_drop), ("stall", self.p_stall),
                        ("corrupt", self.p_corrupt)):
            edge += p
            if u < edge:
                self.injected[kind] += 1
                return kind
        return None


class LaunchFault(RuntimeError):
    """A launch failed to produce harvestable results (dropped / corrupted).

    ``kind`` is the failure class (one of :data:`LAUNCH_FAULTS` for injected
    faults, ``"invalid"`` for organically corrupted buffers caught by harvest
    validation); ``ticket`` the dispatch ordinal of the failed launch.
    """

    def __init__(self, kind: str, ticket: int, detail: str = ""):
        self.kind = kind
        self.ticket = ticket
        super().__init__(
            f"launch {ticket} failed ({kind})" + (f": {detail}" if detail else "")
        )


class SpikeRewind:
    def __init__(self, factor: float = 3.0, patience: int = 2, alpha: float = 0.1):
        self.factor = factor
        self.patience = patience
        self.alpha = alpha
        self.ewma: Optional[float] = None
        self._bad = 0

    def observe(self, loss: float) -> bool:
        """Returns True when the loop should rewind to the last checkpoint."""
        if self.ewma is None:
            self.ewma = loss
            return False
        if loss > self.factor * self.ewma:
            self._bad += 1
            if self._bad >= self.patience:
                self._bad = 0
                return True
            return False
        self._bad = 0
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * loss
        return False
