"""Fault-tolerant multi-tenant serving: one router, many networks (DESIGN §14).

:class:`BayesRouter` multiplexes many :class:`~repro_torch.bayesnet.compile.
CompiledNetwork`\\ s behind one submit/harvest API.  Each *tenant* (a scenario
spec) gets a scenario-keyed plan-cache entry -- compiled lazily, LRU-evicted
only while idle -- and its own :class:`~repro_torch.bayesnet.driver.FrameDriver`
whose entropy is isolated by the existing ``base_key``/``salt`` fold: the
tenant salt is a stable CRC of the scenario name, so a router tenant's
posteriors are *bit-identical* to a standalone per-scenario driver constructed
with the same ``(base_key, salt)`` (a gated property, not an aspiration).
Frames coalesce into the driver's power-of-two launch buckets exactly as they
would single-tenant.

The serving story is designed around things going wrong:

**Deadline-aware admission.**  Every request carries a deadline (default the
paper's 0.4 ms budget x ``RouterPolicy.deadline_mult``); the pending queue is
a deadline-ordered heap, not FIFO.  A request whose deadline cannot be met --
already expired, or the tenant's earliest dispatch time (backoff, open
breaker) plus its launch-time estimate (the driver watchdog's EWMA) lands past
it -- is shed with an explicit ``REJECTED`` status instead of silently
queued: under a hard deadline, an honest no now beats a useless yes later.

**Failure containment.**  Launch failures surface through the driver's
all-or-nothing harvest (:class:`~repro_torch.bayesnet.driver.LaunchFailure`): the
router responds with failover re-dispatch under fresh entropy (the driver's
launch counter advanced, so a re-launch never replays the failed draw),
per-tenant capped exponential backoff, and a per-tenant circuit breaker that
trips after ``breaker_threshold`` consecutive failures.  A tripped tenant is
degraded -- its requests shed or deferred -- rather than allowed to poison
the shared queue; after ``breaker_cooldown_s`` the next batch is the
half-open probe whose outcome closes or re-trips the breaker.

**Graceful degradation.**  When the deadline-feasible queue exceeds
``capacity``, new launches are downgraded along an n_bits ladder
(``base / degrade_step^level``, floored and 32-aligned -- fewer bits = a
faster launch, the same knob :class:`~repro_torch.bayesnet.reliability.RetryPolicy`
escalates in the other direction) and their results flagged ``DEGRADED``.

Every submitted frame therefore terminates in exactly one of
``OK | DEGRADED | UNRELIABLE | REJECTED``
(:data:`~repro_torch.bayesnet.reliability.TERMINAL_STATUSES`) -- no frame is ever
silently dropped, extending the retry layer's never-drop invariant from the
frame to the fleet.  ``chip_smoke.py``'s router phase holds it on the card
under seeded 5% launch-fault chaos.

**Crossbar health (DESIGN §15).**  ``drift=DriftPolicy(...)`` gives every
tenant its own :class:`~repro_torch.bayesnet.reliability.DriftMonitor`, fed by all
its ladder-rung drivers: per-launch confidence and accept-rate run through
CUSUM detectors and escalate a HEALTHY -> DRIFTING -> RECALIBRATING state
machine the router consumes alongside the circuit breaker.  When a noisy
tenant latches ``RECALIBRATING`` (and ``auto_recalibrate=True``), the next
harvest round hot-swaps a calibrate-back twin
(:func:`~repro_torch.bayesnet.calibrate.recalibrated_network`, at the tenant's
launch-counter cycle estimate) into every rung driver between launches --
zero frames lost or reordered -- and resets the monitor.
:meth:`BayesRouter.recalibrate` is the manual trigger,
:meth:`BayesRouter.health` the state probe.

**Devices.**  ``device=`` (default ``"cuda"``) is where every tenant's plans
are compiled and launched: the generated ``net_sweep`` kernel on the card, or
its plain torch version for ``device="cpu"``.  A router asked for the card
where there is none raises at construction; nothing falls back to the CPU.
Plans compile where the reference compiles them -- lazily, when a rung's
driver is first needed -- and a recalibration re-lowers every rung in the
harvest round that finds the latch, so on the card the twin's ``nvcc``
build runs inside that pump round.

A degradation/retry interaction is also closed here: a DEGRADED tenant's
:class:`~repro_torch.bayesnet.reliability.RetryPolicy` escalation is clamped to
the rung's n_bits (a degraded rung must not escalate its way back to full
fidelity through the retry back door); clamped frames carry
``FrameReport.escalation_clamped``.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.bayesnet.calibrate import recalibrated_network
from repro_torch.bayesnet.compile import compile_network
from repro_torch.bayesnet.driver import FrameDriver
from repro_torch.bayesnet.noise import NoiseModel
from repro_torch.bayesnet.reliability import (
    HEALTH_HEALTHY,
    HEALTH_RECALIBRATING,
    STATUS_DEGRADED,
    STATUS_OK,
    STATUS_REJECTED,
    STATUS_UNRELIABLE,
    TERMINAL_STATUSES,
    DriftMonitor,
    DriftPolicy,
    RetryPolicy,
)
from repro_torch.bayesnet.scenarios import by_name
from repro_torch.bayesnet.spec import NetworkSpec
from repro_torch.core import prng
from repro_torch.distributed.fault import LaunchFaultInjector
from repro_torch.kernels import backend
from repro_torch.obs import PAPER_BUDGET_MS, MetricsRegistry, Tracer


def tenant_salt(name: str) -> int:
    """Stable per-tenant entropy salt: CRC32 of the scenario name.

    A pure function of the name, so a router tenant and a standalone
    :class:`~repro_torch.bayesnet.driver.FrameDriver` built with this salt (and the
    same ``base_key``) draw bit-identical launch entropy -- the router's
    bit-identity contract.
    """
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


@dataclasses.dataclass(frozen=True)
class RouterPolicy:
    """Admission, degradation, and failure-response knobs.

    ``deadline_mult``: default request deadline as a multiple of the paper's
    0.4 ms budget (the default 2500x = 1 s absorbs host jitter; tighten it on
    quiet hardware).  ``capacity``: deadline-feasible queued frames above
    which new launches degrade; each further ``capacity`` frames of depth adds
    a degradation level, up to ``max_degrade``.  ``degrade_step``: n_bits
    divisor per level (floored at ``min_n_bits``, 32-aligned).
    ``breaker_threshold``: consecutive failed launches that trip a tenant's
    circuit breaker; ``breaker_cooldown_s``: how long a tripped tenant waits
    before its half-open probe.  ``backoff_base_s`` / ``backoff_cap_s``:
    capped exponential re-dispatch backoff after each failure.
    ``max_redispatch``: per-frame failed-launch budget before the frame is
    emitted flagged (:class:`~repro_torch.bayesnet.driver.FrameDriver`'s knob).
    """

    deadline_mult: float = 2500.0
    capacity: int = 4096
    degrade_step: int = 4
    max_degrade: int = 2
    min_n_bits: int = 128
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 0.25
    backoff_base_s: float = 0.002
    backoff_cap_s: float = 0.1
    max_redispatch: int = 3

    def __post_init__(self):
        if self.deadline_mult <= 0:
            raise ValueError(f"deadline_mult must be > 0, got {self.deadline_mult}")
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        if self.degrade_step < 2:
            raise ValueError(f"degrade_step must be >= 2, got {self.degrade_step}")
        if self.max_degrade < 0:
            raise ValueError(f"max_degrade must be >= 0, got {self.max_degrade}")
        if self.breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got {self.breaker_threshold}"
            )

    @property
    def default_deadline_s(self) -> float:
        return PAPER_BUDGET_MS * self.deadline_mult / 1e3


@dataclasses.dataclass(frozen=True)
class RouterResult:
    """One frame's terminal verdict: exactly one per submitted frame.

    ``status`` is one of :data:`~repro_torch.bayesnet.reliability.TERMINAL_STATUSES`.
    ``post`` is ``None`` only for ``REJECTED`` (the frame never launched);
    an ``UNRELIABLE`` frame that exhausted its failover budget carries the
    zero posterior with ``accepted == 0``.  ``degrade_level`` is the n_bits
    ladder rung the frame was served at (0 = full fidelity);
    ``deadline_met`` whether the terminal verdict landed inside the request's
    deadline (always ``True`` for an admission-time ``REJECTED``: shedding
    *is* the in-deadline answer).
    """

    rid: int
    tenant: str
    status: str
    post: Optional[np.ndarray]
    accepted: int
    degrade_level: int
    latency_ms: float
    deadline_met: bool


@dataclasses.dataclass
class _Request:
    rid: int
    tenant: str
    row: np.ndarray
    deadline: float         # absolute perf_counter time
    t_submit: float
    dispatch_seq: int = -1  # global dispatch order (admission-order probe)
    level: int = 0


class _Tenant:
    """One scenario's serving state: plans per degrade level + breaker."""

    def __init__(self, router: "BayesRouter", spec: NetworkSpec, name: str,
                 salt: int, n_bits: int, noise: Optional[NoiseModel]):
        self.router = router
        self.spec = spec
        self.name = name
        self.salt = salt
        self.n_bits = n_bits
        self.noise = noise
        self.drivers: Dict[int, FrameDriver] = {}
        self.rid_map: Dict[Tuple[int, int], int] = {}  # (level, driver_rid) -> rid
        self._fail_cursor: Dict[int, int] = {}
        self.consecutive_failures = 0
        self.not_before = 0.0                  # backoff gate (abs time)
        self.breaker_open_until: Optional[float] = None
        self.trips = 0
        # one health monitor per tenant, shared by every ladder-rung driver
        self.monitor: Optional[DriftMonitor] = (
            DriftMonitor(router.drift, metrics=router.metrics, name=name)
            if router.drift is not None else None
        )
        self.recalibrations = 0

    # ------------------------------------------------------------------ plans
    def n_bits_for(self, level: int) -> int:
        p = self.router.policy
        n = self.n_bits // (p.degrade_step ** level)
        n = max(32, p.min_n_bits, (n // 32) * 32)
        return min(n, self.n_bits)

    def driver(self, level: int) -> Tuple[FrameDriver, int]:
        """The (lazily built, cached) driver for one ladder rung.

        Returns ``(driver, effective_level)``: a rung whose floored n_bits
        equals a shallower rung's collapses onto it, so "degraded" is never
        claimed without an actual fidelity cut.
        """
        while level > 0 and self.n_bits_for(level) == self.n_bits_for(level - 1):
            level -= 1
        d = self.drivers.get(level)
        if d is None:
            r = self.router
            if r.metrics is not None:
                r.metrics.inc("router_plan_compiles")
            rung = self.n_bits_for(level)
            net = compile_network(
                self.spec, rung, noise=self.noise, trace=r.trace, device=r.device,
            )
            retry = r.retry
            if level > 0 and retry is not None and retry.max_n_bits > rung:
                # a DEGRADED rung must not escalate past its own fidelity
                # cut: clamp the retry ladder to the rung's n_bits (frames
                # that hit the clamp carry FrameReport.escalation_clamped)
                retry = dataclasses.replace(retry, max_n_bits=rung)
            # level folds into the salt so ladder rungs draw disjoint
            # entropy; level 0 keeps the bare tenant salt -- the
            # bit-identity contract with a standalone driver
            d = FrameDriver(
                net, max_batch=r.max_batch, base_key=r.base_key,
                salt=self.salt + 7919 * level, retry=retry,
                trace=r.trace, metrics=r.metrics, fault=r.fault,
                max_redispatch=r.policy.max_redispatch,
                drift=self.monitor,
            )
            self.drivers[level] = d
            self._fail_cursor[level] = 0
        return d, level

    # ---------------------------------------------------------------- failure
    def earliest_dispatch(self, now: float) -> float:
        t = max(now, self.not_before)
        if self.breaker_open_until is not None:
            t = max(t, self.breaker_open_until)
        return t

    def launch_estimate(self) -> float:
        """Best-case launch wall time: the watchdog's steady-state floor.

        ``StragglerWatch.min_dt`` excludes the EWMA seed (where a one-off
        first-launch cost hides) and flagged stragglers, so this is the tenant's
        genuine capability floor -- optimistic by construction.  Admission
        sheds a request only when *even this best case* lands past its
        deadline; pessimistic estimates (the raw EWMA) were tried and shed
        healthy tenants forever after one 8-second compile seeded them.
        0.0 while cold: a tenant that has never launched is never presumed
        infeasible.
        """
        d = self.drivers.get(0)
        if d is None or d.watch.min_dt is None:
            return 0.0
        return float(d.watch.min_dt)

    @property
    def breaker_open(self) -> bool:
        return self.breaker_open_until is not None

    def idle(self) -> bool:
        return not self.rid_map and all(
            d.pending == 0 and d.in_flight == 0 and d.pending_retries == 0
            for d in self.drivers.values()
        )

    def new_failures(self) -> list:
        """Launch failures recorded by any rung's driver since the last scan."""
        out = []
        for level, d in self.drivers.items():
            cur = self._fail_cursor.get(level, 0)
            out.extend(d.launch_failures[cur:])
            self._fail_cursor[level] = len(d.launch_failures)
        return out

    # ----------------------------------------------------------------- health
    @property
    def health(self) -> str:
        """HEALTHY / DRIFTING / RECALIBRATING (HEALTHY when unmonitored)."""
        return self.monitor.state if self.monitor is not None else HEALTH_HEALTHY

    def cycle_estimate(self) -> int:
        """Crossbar wear estimate: total launches across every rung driver.

        One launch reads every device of the array once per stream position,
        so the launch count is the natural unit the noise model's ``cycle``
        axis advances in.
        """
        return sum(d.launches for d in self.drivers.values())

    def recalibrate(self, cycle: float | None = None) -> int:
        """Hot-swap a calibrate-back twin into every rung driver.

        ``cycle=None`` uses :meth:`cycle_estimate`.  Each rung's network is
        re-lowered at that cycle with a compensated program
        (:func:`~repro_torch.bayesnet.calibrate.recalibrated_network`) and swapped
        between launches -- in-flight launches harvest against their
        original plan, so no frame is lost or reordered.  Resets the drift
        monitor (back to HEALTHY, baselines re-learned against the
        recalibrated array).  Returns the cycle used.  Raises if the tenant
        has no noise model: a clean tenant has no drift to calibrate back.
        """
        if self.noise is None:
            raise ValueError(
                f"tenant {self.name!r} has no noise model: nothing to recalibrate"
            )
        c = int(self.cycle_estimate() if cycle is None else cycle)
        for drv in self.drivers.values():
            drv.swap_net(recalibrated_network(drv.net, c))
        self.recalibrations += 1
        if self.monitor is not None:
            self.monitor.reset()
        r = self.router
        if r.metrics is not None:
            r.metrics.inc("router_recalibrations")
        if r.trace is not None:
            r.trace.event("router.recalibrate", tenant=self.name, cycle=c)
        return c


class BayesRouter:
    """Multi-tenant fault-tolerant frame router (module docstring).

    ``submit(scenario, frames, deadline_ms=...)`` -> rids;
    ``pump()`` runs one scheduling round (admit -> dispatch -> harvest);
    ``harvest()`` pops results terminal since the last call;
    ``drain()`` pumps until every submitted frame is terminal.
    ``results`` keeps every terminal :class:`RouterResult` for accounting.

    Tenants auto-register on first submit (scenario-library names or
    :class:`~repro_torch.bayesnet.spec.NetworkSpec` objects); the plan cache holds
    ``max_cached_tenants`` compiled tenants and evicts least-recently-used
    *idle* tenants only -- a tenant with frames in flight is never evicted.
    Tenant salts persist across eviction, so a re-registered tenant keeps its
    entropy identity (its launch counter restarts, as any restart does).

    ``base_key`` is ``(2,)`` uint32 key data (:mod:`repro_torch.core.prng`),
    default ``prng.PRNGKey(0)``; ``device`` is where every plan runs.
    """

    def __init__(
        self,
        policy: RouterPolicy | None = None,
        base_key=None,
        *,
        n_bits: int = 4096,
        max_batch: int = 256,
        retry: RetryPolicy | None = None,
        fault: LaunchFaultInjector | None = None,
        trace: Tracer | None = None,
        metrics: MetricsRegistry | None = None,
        max_cached_tenants: int = 8,
        drift: DriftPolicy | None = None,
        auto_recalibrate: bool = True,
        device="cuda",
    ):
        if max_cached_tenants < 1:
            raise ValueError(
                f"max_cached_tenants must be >= 1, got {max_cached_tenants}"
            )
        if drift is not None and not isinstance(drift, DriftPolicy):
            raise TypeError(
                f"drift must be a DriftPolicy or None, got {type(drift)!r}"
            )
        self.device = backend.resolve_device(device)   # raises if the card is absent
        self.policy = policy if policy is not None else RouterPolicy()
        self.base_key = prng.key_data(
            base_key if base_key is not None else prng.PRNGKey(0)
        )
        self.n_bits = int(n_bits)
        self.max_batch = int(max_batch)
        self.retry = retry
        self.fault = fault
        self.drift = drift
        self.auto_recalibrate = bool(auto_recalibrate)
        self.trace = trace
        if metrics is None and trace is not None:
            metrics = MetricsRegistry()
        self.metrics = metrics
        self.max_cached_tenants = int(max_cached_tenants)
        self._tenants: "OrderedDict[str, _Tenant]" = OrderedDict()
        self._salts: Dict[str, int] = {}       # survives eviction
        self._pending: list = []               # heap of (deadline, seq, rid)
        self._seq = 0
        self._dispatch_seq = 0
        self._next_rid = 0
        self.requests: Dict[int, _Request] = {}
        self.results: Dict[int, RouterResult] = {}
        self._fresh: Dict[int, RouterResult] = {}

    # ------------------------------------------------------------- tenants
    def register(
        self,
        scenario: Union[str, NetworkSpec],
        *,
        salt: int | None = None,
        n_bits: int | None = None,
        noise: NoiseModel | None = None,
    ) -> str:
        """Get-or-create a tenant; returns its name (LRU-touched).

        ``salt`` overrides the default CRC-of-name entropy salt (it persists
        across evictions either way).  ``n_bits`` / ``noise`` apply on first
        registration only -- a cached tenant's plans are already built.
        """
        name = scenario if isinstance(scenario, str) else scenario.name
        t = self._tenants.get(name)
        if t is not None:
            self._tenants.move_to_end(name)
            return name
        spec = by_name(scenario) if isinstance(scenario, str) else scenario
        if salt is not None:
            self._salts[name] = int(salt)
        else:
            self._salts.setdefault(name, tenant_salt(name))
        t = _Tenant(
            self, spec, name, self._salts[name],
            int(n_bits) if n_bits is not None else self.n_bits, noise,
        )
        self._tenants[name] = t
        if self.metrics is not None:
            self.metrics.inc("router_tenant_registrations")
            self.metrics.set_gauge("router_tenants", len(self._tenants))
        self._evict_idle()
        return name

    def _evict_idle(self) -> None:
        """LRU-evict idle tenants past capacity (live tenants are immune)."""
        while len(self._tenants) > self.max_cached_tenants:
            victim = next(
                (n for n, t in self._tenants.items() if t.idle()), None
            )
            if victim is None:   # everything busy: run over capacity
                return
            del self._tenants[victim]
            if self.metrics is not None:
                self.metrics.inc("router_tenant_evictions")
                self.metrics.set_gauge("router_tenants", len(self._tenants))

    def tenant(self, name: str) -> _Tenant:
        """The live tenant record (registers scenario-library names lazily)."""
        if name not in self._tenants:
            self.register(name)
        return self._tenants[name]

    # ----------------------------------------------------------- admission
    def submit(
        self,
        scenario: Union[str, NetworkSpec],
        frames,
        deadline_ms: float | None = None,
    ) -> List[int]:
        """Queue evidence frames for one tenant; returns rids.

        ``deadline_ms`` is relative to now (default
        ``policy.default_deadline_s``).  Requests that already cannot be
        scheduled inside their deadline -- expired on arrival, or the
        tenant's earliest dispatch plus its launch estimate lands past it --
        are shed immediately with ``REJECTED`` rather than silently queued.
        """
        name = self.register(scenario)
        t = self._tenants[name]
        frames = np.asarray(frames, np.int32)
        if frames.ndim == 1:
            frames = frames[None, :]
        now = time.perf_counter()
        deadline = now + (
            deadline_ms / 1e3 if deadline_ms is not None
            else self.policy.default_deadline_s
        )
        rids = []
        est = t.launch_estimate()
        for row in frames:
            rid = self._next_rid
            self._next_rid += 1
            req = _Request(rid, name, row, deadline, now)
            self.requests[rid] = req
            rids.append(rid)
            if t.earliest_dispatch(now) + est > deadline:
                self._finish(req, STATUS_REJECTED, None, 0, now)
                continue
            heapq.heappush(self._pending, (deadline, self._seq, rid))
            self._seq += 1
        if self.metrics is not None:
            self.metrics.inc("router_submitted", len(rids))
            self.metrics.set_gauge("router_pending", len(self._pending))
        if self.trace is not None:
            self.trace.event("router.submit", tenant=name, n=len(rids))
        return rids

    @property
    def pending(self) -> int:
        return len(self._pending)

    # ------------------------------------------------------------ the pump
    def pump(self) -> int:
        """One scheduling round: admit -> dispatch -> harvest.

        Returns the number of frames that reached a terminal status this
        round.  Admission walks the deadline heap in order: expired and
        infeasible requests shed as ``REJECTED``, dispatchable ones grouped
        per tenant (deadline order preserved within the group) and handed to
        the tenant's driver at the ladder rung the current queue depth
        demands; tenants inside a backoff window or an open breaker keep
        their feasible requests queued for a later round.
        """
        if self.trace is None:
            return self._pump_impl()
        with self.trace.span("router.pump", pending=len(self._pending)):
            return self._pump_impl()

    def _pump_impl(self) -> int:
        before = len(self.results)
        now = time.perf_counter()
        self._admit(now)
        self._dispatch(now)
        self._harvest_drivers()
        if self.metrics is not None:
            self.metrics.set_gauge("router_pending", len(self._pending))
        return len(self.results) - before

    def _degrade_level(self, depth: int) -> int:
        """Ladder rung for the current feasible queue depth (0 = nominal)."""
        return min(self.policy.max_degrade, depth // self.policy.capacity)

    def _admit(self, now: float) -> None:
        """Deadline-ordered admission from the heap into tenant drivers."""
        rounds: "OrderedDict[str, List[_Request]]" = OrderedDict()
        requeue: List[Tuple[float, int, int]] = []
        depth = len(self._pending)
        while self._pending:
            deadline, seq, rid = heapq.heappop(self._pending)
            req = self.requests[rid]
            if rid in self.results:
                continue
            t = self.tenant(req.tenant)
            est = t.launch_estimate()
            if deadline < now or t.earliest_dispatch(now) + est > deadline:
                # cannot be scheduled in time: shed explicitly, never queue
                self._finish(req, STATUS_REJECTED, None, 0, now)
                if self.metrics is not None:
                    self.metrics.inc(
                        "router_shed_expired" if deadline < now
                        else "router_shed_infeasible"
                    )
                continue
            if t.earliest_dispatch(now) > now:
                # feasible later (backoff / breaker cooldown): stay queued
                requeue.append((deadline, seq, rid))
                continue
            rounds.setdefault(req.tenant, []).append(req)
        for item in requeue:
            heapq.heappush(self._pending, item)
        level = self._degrade_level(depth)
        for name, reqs in rounds.items():
            t = self._tenants[name]
            probe = t.breaker_open
            drv, eff = t.driver(level)
            drv_rids = drv.submit(np.stack([r.row for r in reqs]))
            for req, dr in zip(reqs, drv_rids):
                t.rid_map[(eff, dr)] = req.rid
                req.level = eff
                req.dispatch_seq = self._dispatch_seq
                self._dispatch_seq += 1
            if probe and self.metrics is not None:
                self.metrics.inc("router_breaker_probes")

    def _dispatch(self, now: float) -> None:
        """Flush every dispatchable tenant's driver queues (async launches)."""
        for t in self._tenants.values():
            if t.earliest_dispatch(now) > now:
                continue
            for drv in t.drivers.values():
                while drv.pending or drv.pending_retries:
                    drv.step(block=False)

    def _harvest_drivers(self) -> None:
        """Harvest every tenant, map statuses, update breaker/backoff state."""
        p = self.policy
        for name, t in self._tenants.items():
            emitted = 0
            for level, drv in list(t.drivers.items()):
                if drv.in_flight == 0:
                    continue
                res = drv.harvest()
                t_now = time.perf_counter()
                for dr, (post, accepted) in res.items():
                    rid = t.rid_map.pop((level, dr), None)
                    if rid is None:
                        continue
                    req = self.requests[rid]
                    report = drv.reports.get(dr)
                    if report is not None and not report.reliable:
                        status = STATUS_UNRELIABLE
                    elif level > 0:
                        status = STATUS_DEGRADED
                    else:
                        status = STATUS_OK
                    self._finish(req, status, post, int(accepted), t_now)
                    emitted += 1
            fails = t.new_failures()
            now = time.perf_counter()
            if fails:
                t.consecutive_failures += len(fails)
                backoff = min(
                    p.backoff_cap_s,
                    p.backoff_base_s * 2 ** (t.consecutive_failures - 1),
                )
                t.not_before = now + backoff
                if (
                    t.consecutive_failures >= p.breaker_threshold
                    and not t.breaker_open
                ):
                    t.breaker_open_until = now + p.breaker_cooldown_s
                    t.trips += 1
                    if self.metrics is not None:
                        self.metrics.inc("router_breaker_trips")
                    if self.trace is not None:
                        self.trace.event(
                            "router.breaker_trip", tenant=name,
                            failures=t.consecutive_failures,
                        )
            elif emitted:
                # a clean harvest closes the loop: breaker shuts (the
                # half-open probe succeeded), backoff resets
                t.consecutive_failures = 0
                t.not_before = 0.0
                if t.breaker_open:
                    t.breaker_open_until = None
                    if self.metrics is not None:
                        self.metrics.inc("router_breaker_closes")
            if t.breaker_open and now >= t.breaker_open_until:
                # cooldown elapsed: half-open -- admission resumes, the next
                # batch is the probe (its harvest closes or re-trips above)
                pass
            if (
                self.auto_recalibrate
                and t.monitor is not None
                and t.noise is not None
                and t.monitor.state == HEALTH_RECALIBRATING
            ):
                # the detector latched: hot-swap calibrate-back twins into
                # every rung between launches (in-flight work unaffected)
                t.recalibrate()

    def _finish(
        self, req: _Request, status: str, post, accepted: int, now: float
    ) -> None:
        assert status in TERMINAL_STATUSES, status
        latency_ms = (now - req.t_submit) * 1e3
        met = status == STATUS_REJECTED or now <= req.deadline
        r = RouterResult(
            rid=req.rid, tenant=req.tenant, status=status, post=post,
            accepted=accepted, degrade_level=req.level,
            latency_ms=latency_ms, deadline_met=met,
        )
        self.results[req.rid] = r
        self._fresh[req.rid] = r
        mx = self.metrics
        if mx is not None:
            mx.inc(f"router_{status.lower()}")
            if not met:
                mx.inc("router_deadline_miss")
            if status != STATUS_REJECTED:
                mx.hist(
                    f"router_{req.tenant}_frame_ms", budget_ms=PAPER_BUDGET_MS
                ).observe(latency_ms)

    # -------------------------------------------------------------- health
    def health(self, scenario: str) -> str:
        """A tenant's drift-health state (HEALTHY when unmonitored)."""
        return self.tenant(scenario).health

    def recalibrate(self, scenario: str, cycle: float | None = None) -> int:
        """Manually hot-swap calibrate-back plans into one tenant's drivers.

        Returns the cycle the recalibration was fitted at (default the
        tenant's launch-counter estimate); see :meth:`_Tenant.recalibrate`.
        """
        return self.tenant(scenario).recalibrate(cycle)

    # ------------------------------------------------------------- results
    def harvest(self) -> Dict[int, RouterResult]:
        """Results that turned terminal since the last ``harvest`` call."""
        out = self._fresh
        self._fresh = {}
        return out

    def _live_work(self) -> bool:
        return bool(self._pending) or any(
            not t.idle() for t in self._tenants.values()
        )

    def drain(self, max_rounds: int = 100_000) -> Dict[int, RouterResult]:
        """Pump until every submitted frame is terminal; returns the fresh set.

        Backoff windows are honoured by sleeping to the earliest tenant gate
        when a round made no progress, so a drain through a failure storm
        converges instead of spinning.
        """
        out = self.harvest()
        for _ in range(max_rounds):
            if not self._live_work():
                return out
            progressed = self.pump()
            out.update(self.harvest())
            if progressed == 0 and self._live_work():
                now = time.perf_counter()
                gates = [
                    t.earliest_dispatch(now) for t in self._tenants.values()
                    if not t.idle()
                ]
                wait = min((g - now for g in gates), default=0.0)
                if wait > 0:
                    time.sleep(min(wait, 0.05))
        raise RuntimeError(
            f"router drain did not converge in {max_rounds} rounds "
            f"({len(self._pending)} pending)"
        )

    def status_counts(self) -> Dict[str, int]:
        """Terminal-status histogram over every result so far."""
        out = {s: 0 for s in TERMINAL_STATUSES}
        for r in self.results.values():
            out[r.status] += 1
        return out
