"""Streaming frame driver: serve-style batching for compiled networks.

Mirrors the LM serving engine's admission discipline on the bayesnet side:
frames are submitted at any time into a pending queue, and every ``step``
packs up to ``max_batch`` of them, runs the compiled program once, and
returns per-request posteriors.  Launch shapes are drawn from a small ladder
of power-of-two *buckets* (1, 2, 4, ... max_batch): a short batch pads up to
the nearest bucket by repeating its last real frame instead of always paying
the full ``max_batch`` lanes, so a 1-frame step on a 1024-lane driver costs
one frame's entropy, not ~1024x.  Padded lanes are dropped at harvest; each
bucket compiles once and is reused for every launch of that shape.

With the fused independent-entropy default (``compile_network``'s production
mode) every frame in a launch carries its own joint sample, so batch-mates
never share errors.  The driver also sequences launch keys itself: pass
``key=None`` to ``step`` / ``drain`` and each launch folds a monotonically
increasing launch counter into the driver's base key, so successive launches
draw disjoint entropy without the caller threading PRNG state.

**Async mode.**  ``step(block=False)`` dispatches the launch and returns
immediately with its ticket: the kernel runs on the current CUDA stream while
the driver packs and dispatches the next batch, and nothing waits until
``harvest()`` synchronises on the launch's recorded ``torch.cuda.Event`` and
copies the posteriors to host arrays.  ``drain_async`` pipelines the whole
queue this way -- every launch in flight back-to-back, one synchronisation at
the end.  The launch-counter
key sequencing makes this safe: tickets are assigned at dispatch in
submission order, so async results map to rids exactly as sync results do,
and a sync and an async driver with the same ``(base_key, salt)`` return
bit-identical posteriors.

Every driver additionally folds a ``salt`` into its base key.  ``salt=None``
(the default) takes the next value of a process-wide driver counter, so two
drivers constructed with defaults -- the footgun the old ``PRNGKey(0)``
default base key armed -- no longer draw bit-identical joint samples per
launch index.  Pass an explicit ``salt`` (a driver id) to make a driver's key
sequence reproducible across processes/restarts: drivers with the same
``(base_key, salt)`` replay the same launches, drivers differing in either
draw disjoint entropy.

**Confidence-gated retry.**  ``retry=RetryPolicy(...)`` makes reliability a
measured, acted-on property: every harvested frame gets a decision-margin
confidence (:func:`~repro_torch.bayesnet.reliability.decision_confidence`), and
frames below ``min_confidence`` are re-queued for a fresh launch -- new
entropy via the launch counter, ``escalation``-times longer bitstream per
attempt (escalated programs compile lazily, once per attempt level, and are
cached like buckets).  After ``max_retries`` the frame is emitted anyway with
``reliable=False`` -- graceful degradation, never a dropped frame.  Results
keep the legacy ``{rid: (post, accepted)}`` shape; per-frame verdicts land in
``driver.reports[rid]`` (:class:`~repro_torch.bayesnet.reliability.FrameReport`)
and aggregates in ``driver.stats``
(:class:`~repro_torch.bayesnet.reliability.ReliabilityStats`).  With retry enabled
a ``step`` may dispatch several launches (one per pending attempt level plus
the main batch); an explicit ``key`` is folded with the launch index within
the step.  ``retry=None`` (default) is behaviour-identical to the
pre-reliability driver.

**Launch watchdog.**  Every dispatch's wall time feeds a
:class:`~repro_torch.distributed.fault.StragglerWatch` EWMA (the train-loop
straggler detector, reused verbatim): dispatches slower than ``threshold x``
the running mean -- a recompile for a new bucket shape, a contended device,
host-side stalls -- are counted in ``stats.slow_launches``.  Under async
dispatch the wall time covers plan lowering + enqueue, which is exactly the
host-side latency a serving deployment cares about.

**Telemetry.**  ``trace=Tracer()`` / ``metrics=MetricsRegistry()``
(:mod:`repro_torch.obs`) light up the whole serving path with zero behaviour
change -- the traced driver's posteriors are bit-identical to the untraced
one's (a regression-tested property, like the <=5% overhead bound).  Each
launch becomes a span tree honouring async dispatch: a ``launch[n]``
parent span from dispatch to harvest, ``pack`` and ``dispatch`` sync child
spans for the host-side work, a ``device`` child opened when the dispatch
call returns and closed only when :meth:`harvest` first blocks on the result
(overlapping ``device`` spans in the exported trace ARE the async pipeline),
and a ``harvest`` child for host-side conversion + confidence gating.
Retried frames get ``retry[rid]`` spans nested under the launch that flagged
them, covering the wait until their re-launch's verdict.  The registry
counts frames in/out, launches, per-bucket launch shapes, padded lanes,
retry attempts per rung, flagged-unreliable emissions, escalated-plan cache
hits/misses, and entropy words generated, and feeds ``frame_ms`` (enqueue ->
emit, annotated with the paper's 0.4 ms budget) and ``launch_ms``
(dispatch -> harvest) histograms; the watchdog writes into the same registry.
``trace=None`` (default) leaves every hot path untouched.

**Fault tolerance.**  ``fault=LaunchFaultInjector(...)`` threads seeded chaos
through the launch path (dropped launches, stalled dispatches, corrupted
harvest buffers), and :meth:`harvest` is all-or-nothing *per launch* either
way: every harvested buffer is validated (finite posteriors, non-negative
accepted counts), and any exception while processing one launch -- injected
or organic -- recovers instead of stranding the fleet.  Recovery closes the
launch's spans, records a :class:`LaunchFailure` (``driver.launch_failures``,
``stats.launch_failures``), and re-enqueues the launch's frames at the front
of their queue so the next ``step`` re-dispatches them with *fresh entropy*
(the launch counter advanced, so a re-launch never replays the failed draw).
A frame that fails ``max_redispatch`` launches is emitted with a zero
posterior, ``accepted=0`` and a ``reliable=False`` report -- the never-drop
invariant extends to failing hardware: every submitted frame terminates.
``fault=None`` with healthy buffers is bit-identical to the pre-fault driver.

**Drift monitoring + hot-swap.**  ``drift=DriftMonitor(...)`` feeds every
harvested launch's mean decision confidence and accept-rate into the
monitor's CUSUM detectors (:mod:`repro_torch.bayesnet.reliability`), so a driver
notices its own crossbar aging without an oracle in the loop.  The
complementary actuator is :meth:`swap_net`: replace the compiled program
*between launches* -- typically with a recalibrated twin from
:mod:`repro_torch.bayesnet.calibrate` -- without dropping or reordering a single
frame.  Every in-flight launch harvests against the plan it dispatched with
(device buffers and the stream length are snapshotted per launch at
dispatch), queued frames simply ride the next launch on the new plan, and
the launch counter keeps advancing so entropy stays disjoint across the
swap.  ``drift=None`` (default) costs nothing on the hot path.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.bayesnet.compile import CompiledNetwork, compile_network
from repro_torch.bayesnet.reliability import (
    DriftMonitor,
    FrameReport,
    ReliabilityStats,
    RetryPolicy,
    decision_confidence,
)
from repro_torch.core import prng
from repro_torch.distributed.fault import LaunchFault, LaunchFaultInjector, StragglerWatch
from repro_torch.kernels import backend
from repro_torch.obs import PAPER_BUDGET_MS, MetricsRegistry, Tracer

# Process-wide source of default driver salts (one per construction); the
# port's own counter, independent of any other package's.
_DRIVER_IDS = itertools.count()


@dataclasses.dataclass
class _InFlight:
    """One dispatched-but-unharvested launch (dispatch order preserved)."""

    ticket: int
    taken: list                      # (rid, row, attempt, bits_before) tuples
    attempt: int
    post: object                     # device posteriors (None for a dropped launch)
    accepted: object                 # device accepted counts (None when dropped)
    done: object                     # torch.cuda.Event recorded after the launch
    lspan: Optional[int]             # launch span id
    dspan: Optional[int]             # device span id
    t_dispatch: Optional[float]      # dispatch wall-clock
    n_bits: int                      # stream length of the plan that dispatched
    fault: Optional[str] = None      # injected fault kind, if any
    hspan: Optional[int] = None      # harvest span id (opened at harvest)


@dataclasses.dataclass(frozen=True)
class LaunchFailure:
    """One failed launch, as recorded by :meth:`FrameDriver.harvest`.

    ``kind`` is the injected fault kind when the failure was injected, else
    the :class:`~repro_torch.distributed.fault.LaunchFault` kind (``"invalid"`` for
    organically corrupted buffers) or ``"error"`` for any other exception.
    ``rids`` are the frames that rode the launch (re-enqueued or flagged by
    the recovery path, never dropped).
    """

    ticket: int
    kind: str
    rids: Tuple[int, ...]
    attempt: int
    error: str


class FrameDriver:
    def __init__(
        self,
        net: CompiledNetwork,
        max_batch: int = 256,
        base_key=None,
        salt: int | None = None,
        retry: RetryPolicy | None = None,
        watchdog: StragglerWatch | None = None,
        trace: Tracer | None = None,
        metrics: MetricsRegistry | None = None,
        fault: LaunchFaultInjector | None = None,
        max_redispatch: int = 3,
        drift: DriftMonitor | None = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if retry is not None and not isinstance(retry, RetryPolicy):
            raise TypeError(f"retry must be a RetryPolicy or None, got {type(retry)!r}")
        if max_redispatch < 0:
            raise ValueError(f"max_redispatch must be >= 0, got {max_redispatch}")
        if drift is not None and not isinstance(drift, DriftMonitor):
            raise TypeError(f"drift must be a DriftMonitor or None, got {type(drift)!r}")
        backend.resolve_device(net.device)   # raises if the card is absent
        self.net = net
        self.max_batch = int(max_batch)
        self.retry = retry
        self.fault = fault
        self.drift = drift
        self.max_redispatch = int(max_redispatch)
        self.launch_failures: List[LaunchFailure] = []
        self._fail_counts: Dict[int, int] = {}   # rid -> failed launches so far
        self._queue: deque = deque()
        self._next_rid = 0
        self.salt = next(_DRIVER_IDS) if salt is None else int(salt)
        base = base_key if base_key is not None else prng.PRNGKey(0)
        self._base_key = prng.fold_in(base, self.salt)
        self._launches = 0
        self._dispatches = 0
        self._inflight: deque[_InFlight] = deque()   # in dispatch order
        self.last_launch_shape: Optional[Tuple[int, int]] = None
        # --- telemetry (inert when both are None) ---
        self.trace = trace
        if metrics is None and trace is not None:
            metrics = MetricsRegistry()   # spans without counters are half a story
        self.metrics = metrics
        self._t_submit: Dict[int, float] = {}     # rid -> enqueue wall-clock
        self._retry_spans: Dict[int, int] = {}    # rid -> open retry span id
        # --- reliability layer (inert when retry is None) ---
        self._nets: Dict[int, CompiledNetwork] = {0: net}
        self._retry_q: deque = deque()   # (rid, row, attempt, bits_before)
        self.reports: Dict[int, FrameReport] = {}
        self.stats = ReliabilityStats()
        self.watch = (
            watchdog if watchdog is not None else StragglerWatch(metrics=metrics)
        )

    # ------------------------------------------------------------- admission
    def submit(self, frames) -> List[int]:
        """Queue evidence frames ((n_ev,) each, or an (N, n_ev) array); returns rids."""
        frames = np.asarray(frames, np.int32)
        if frames.ndim == 1:
            frames = frames[None, :]
        if frames.ndim != 2 or frames.shape[1] != len(self.net.evidence):
            raise ValueError(
                f"frames must be (N, {len(self.net.evidence)}), got {frames.shape}"
            )
        rids = []
        for row in frames:
            rid = self._next_rid
            self._next_rid += 1
            self._queue.append((rid, row))
            rids.append(rid)
        if self.metrics is not None:
            now = time.perf_counter()
            for rid in rids:
                self._t_submit[rid] = now
            self.metrics.inc("frames_in", len(rids))
            self.metrics.set_gauge("pending", len(self._queue))
        if self.trace is not None:
            self.trace.event("submit", n=len(rids))
        return rids

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def pending_retries(self) -> int:
        """Frames awaiting a confidence-gated re-launch."""
        return len(self._retry_q)

    @property
    def in_flight(self) -> int:
        """Dispatched launches whose results have not been harvested yet."""
        return len(self._inflight)

    @property
    def launches(self) -> int:
        """Launches dispatched so far -- doubles as the crossbar cycle estimate."""
        return self._launches

    # -------------------------------------------------------------- hot-swap
    def swap_net(self, net: CompiledNetwork) -> None:
        """Replace the compiled program between launches -- zero frame loss.

        The recalibration actuator: swap in a re-lowered twin of the current
        network (same evidence columns, same query layout; typically
        :func:`repro_torch.bayesnet.calibrate.recalibrated_network`) while the
        driver keeps serving.  Ordering guarantees:

        * every **in-flight** launch harvests against the plan it dispatched
          with -- its device buffers and stream length were snapshotted into
          the launch record at dispatch, so posteriors of pre-swap launches
          are bit-identical to a never-swapped driver's;
        * **queued** frames (main or retry) simply ride the next launch on
          the new plan, in their original order -- nothing is dropped,
          re-ordered, or re-keyed;
        * the launch counter keeps advancing, so post-swap launches draw
          entropy disjoint from every pre-swap launch.

        Escalated retry programs are recompiled lazily against the new
        network (the per-attempt cache is reset).
        """
        if not isinstance(net, CompiledNetwork):
            raise TypeError(f"swap_net needs a CompiledNetwork, got {type(net)!r}")
        if tuple(net.evidence) != tuple(self.net.evidence):
            raise ValueError(
                f"swap_net evidence mismatch: {net.evidence} != {self.net.evidence}"
            )
        if tuple(net.query_cards) != tuple(self.net.query_cards):
            raise ValueError(
                "swap_net query layout mismatch: "
                f"{net.query_cards} != {self.net.query_cards}"
            )
        self.net = net
        self._nets = {0: net}
        if self.metrics is not None:
            self.metrics.inc("net_swaps")
        if self.trace is not None:
            self.trace.event("swap_net", n_bits=net.n_bits)

    # ----------------------------------------------------------------- serve
    def _next_key(self) -> np.ndarray:
        key = prng.fold_in(self._base_key, self._launches)
        self._launches += 1
        return key

    def _bucket(self, n_real: int) -> int:
        """Smallest power-of-two launch shape >= n_real (capped at max_batch).

        Padding to a bucket instead of to ``max_batch`` is the tail fix: the
        padded lanes still replicate the last real frame (one static shape
        per bucket), but a nearly-empty step skips the entropy planes of
        every lane above its bucket because those lanes are simply not in
        the launch.
        """
        b = 1
        while b < n_real:
            b <<= 1
        return min(b, self.max_batch)

    def _net_for(self, attempt: int) -> CompiledNetwork:
        """The (lazily compiled, cached) program for one retry attempt level.

        Attempt ``a`` runs ``escalation^a x`` the base stream length, capped
        at the policy's ``max_n_bits``; the escalated program reuses the base
        network's full lowering configuration (queries, evidence, estimator,
        entropy mode, noise model) on the base network's device.
        """
        cached = attempt in self._nets
        if self.metrics is not None:
            self.metrics.inc("plan_cache_hits" if cached else "plan_cache_misses")
        if not cached:
            assert self.retry is not None
            n_bits = self.retry.n_bits_for(self.net.n_bits, attempt)
            self._nets[attempt] = compile_network(
                self.net.spec, n_bits, self.net.queries, self.net.evidence,
                share_entropy=self.net.share_entropy,
                estimator=self.net.estimator, fused=self.net.fused,
                noise=self.net.noise, device=self.net.device, trace=self.trace,
                drift_epochs=self.net.drift_epochs, program=self.net.program,
            )
        return self._nets[attempt]

    def _pack(self, taken: list) -> Tuple[np.ndarray, int]:
        """Stack the taken frames and pad up to their power-of-two bucket."""
        ev = np.stack([row for _, row, _, _ in taken])
        n_real = ev.shape[0]
        bucket = self._bucket(n_real)
        if n_real < bucket:
            pad = np.repeat(ev[-1:], bucket - n_real, axis=0)
            ev = np.concatenate([ev, pad], axis=0)
        return ev, n_real

    def _launch(self, key: np.ndarray | None, taken: list, attempt: int) -> int:
        """Pack one batch at one attempt level, launch it, park the results."""
        tr, mx = self.trace, self.metrics
        lspan = dspan = t_dispatch = None
        if tr is not None:
            lspan = tr.begin(
                f"launch[{self._dispatches}]", track="launch",
                attempt=attempt, n_real=len(taken),
            )
        if key is None:
            key = self._next_key()
        if tr is not None:
            with tr.span("pack", parent=lspan):
                ev, n_real = self._pack(taken)
        else:
            ev, n_real = self._pack(taken)
        self.last_launch_shape = ev.shape
        net = self.net if attempt == 0 else self._net_for(attempt)
        injected = (
            self.fault.draw(self.salt, self._dispatches)
            if self.fault is not None else None
        )
        if mx is not None:
            t_dispatch = time.perf_counter()
        self.watch.step_start()
        if injected == "stall":
            # host-side latency sized to trip the StragglerWatch threshold;
            # the launch itself still runs and harvests normally
            time.sleep(self.fault.stall_ms / 1e3)
        if injected == "drop":
            # the launch never runs: nothing is enqueued, harvest finds no
            # result and routes the frames through the recovery path
            post = accepted = None
        elif tr is not None:
            # host-side dispatch only: net.run returns as soon as the work
            # is enqueued on the stream, so this span is plan lookup +
            # enqueue -- the device interval is the `device` span
            with tr.span("dispatch", parent=lspan, bucket=ev.shape[0]):
                post, accepted = net.run(key, ev)
        else:
            post, accepted = net.run(key, ev)
        done = None
        if post is not None and net.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(net.device))
        ticket = self._dispatches
        self._dispatches += 1
        if self.watch.step_end(ticket):
            self.stats.slow_launches += 1
        self.stats.launches += 1
        if tr is not None:
            dspan = tr.begin("device", parent=lspan, track="device", ticket=ticket)
        if mx is not None:
            mx.inc("launches")
            mx.inc(f"bucket_{ev.shape[0]}")
            mx.inc("padded_lanes", ev.shape[0] - n_real)
            if injected is not None:
                mx.inc(f"fault_injected_{injected}")
            if post is not None:
                mx.inc(
                    "entropy_words",
                    ev.shape[0] * (net.n_bits // 32) * net.spec.n_nodes,
                )
            if attempt > 0:
                mx.inc(f"retry_launches_attempt_{attempt}")
            mx.set_gauge("in_flight", len(self._inflight) + 1)
            mx.set_gauge("pending", len(self._queue))
        self._inflight.append(
            _InFlight(ticket, taken, attempt, post, accepted, done, lspan,
                      dspan, t_dispatch, net.n_bits, fault=injected)
        )
        return ticket

    def _dispatch(self, key: np.ndarray | None) -> int:
        """Pack one main-queue batch (attempt 0), launch it (async)."""
        taken = [
            (rid, row, 0, 0)
            for rid, row in (
                self._queue.popleft()
                for _ in range(min(self.max_batch, len(self._queue)))
            )
        ]
        return self._launch(key, taken, 0)

    def _dispatch_retries(self, key: np.ndarray | None) -> int:
        """Launch one batch from the retry queue (head's attempt level)."""
        attempt = self._retry_q[0][2]
        taken, rest = [], deque()
        while self._retry_q:
            item = self._retry_q.popleft()
            if item[2] == attempt and len(taken) < self.max_batch:
                taken.append(item)
            else:
                rest.append(item)
        self._retry_q = rest
        return self._launch(key, taken, attempt)

    def harvest(self) -> Dict[int, Tuple[np.ndarray, int]]:
        """Block on every in-flight launch and return {rid: (post, accepted)}.

        The single synchronisation point of the async mode: each launch's
        recorded event is synchronised and its device tensors are copied to
        host arrays here (masking the padded lanes out -- only
        real rids appear), in dispatch order, so result mapping follows
        submission order exactly as in the sync path.  With a retry policy,
        under-confidence frames with budget left are re-queued instead of
        returned (dispatch them with the next ``step``/``drain``); emitted
        frames additionally gain a ``reports[rid]`` entry and roll into
        ``stats``.

        **All-or-nothing per launch.**  Harvested buffers are validated
        (finite posteriors, non-negative accepted counts) and any exception
        while converting or gating one launch is caught *per launch*: the
        failed launch's frames are re-enqueued at the front of their queue
        (main or retry, original order preserved, re-dispatched with fresh
        entropy next ``step``) or -- past ``max_redispatch`` failed launches
        -- emitted with a zero posterior and ``reliable=False``; rid maps,
        submit timestamps and span state are restored either way, and the
        remaining in-flight launches harvest normally.  A raise mid-harvest
        can no longer strand the fleet.
        """
        out: Dict[int, Tuple[np.ndarray, int]] = {}
        while self._inflight:
            lf = self._inflight.popleft()
            try:
                self._harvest_one(lf, out)
            except Exception as exc:   # noqa: BLE001 -- per-launch recovery
                self._recover_launch(lf, exc, out)
        return out

    def _harvest_one(self, lf: _InFlight, out: Dict[int, Tuple[np.ndarray, int]]):
        """Convert, validate, and emit one launch (raises on a bad launch)."""
        tr, mx = self.trace, self.metrics
        taken, attempt = lf.taken, lf.attempt
        if tr is not None:
            lf.hspan = tr.begin("harvest", parent=lf.lspan, ticket=lf.ticket)
        if lf.post is None:
            # dropped launch: nothing was ever enqueued
            raise LaunchFault("drop", lf.ticket, "launch produced no result")
        if lf.done is not None:
            lf.done.synchronize()
        post, accepted = lf.post.cpu().numpy(), lf.accepted.cpu().numpy()
        if tr is not None:
            # first observable point at which this launch's device work
            # is complete: the host just blocked on its arrays
            tr.end(lf.dspan)
        if lf.fault == "corrupt":
            # injected buffer corruption: validation below must catch it
            post = np.full_like(post, np.nan)
        if not np.all(np.isfinite(post)):
            raise LaunchFault("invalid", lf.ticket, "non-finite posterior buffer")
        if np.any(accepted < 0):
            raise LaunchFault("invalid", lf.ticket, "negative accepted count")
        t_now = time.perf_counter() if mx is not None else None
        emitted: List[int] = []
        n_real = len(taken)
        n_bits = lf.n_bits   # snapshot from dispatch: immune to swap_net
        conf = None
        if self.retry is not None or self.drift is not None:
            conf = decision_confidence(post[:n_real], accepted[:n_real])
        if self.drift is not None:
            self.drift.observe_launch(
                float(np.mean(conf)),
                float(np.mean(accepted[:n_real])) / max(n_bits, 1),
            )
        if self.retry is None:
            for i, (rid, _, _, _) in enumerate(taken):
                out[rid] = (post[i], int(accepted[i]))
                emitted.append(rid)
        else:
            base = self.net.n_bits
            clamped = bool(
                attempt > 0
                and self.retry.n_bits_for(base, attempt)
                < base * self.retry.escalation ** attempt
            )
            for i, (rid, row, _, bits_before) in enumerate(taken):
                total = bits_before + n_bits
                ok = bool(conf[i] >= self.retry.min_confidence)
                if tr is not None and rid in self._retry_spans:
                    # this launch carried the frame's retry attempt: close
                    # the span opened when it was flagged
                    tr.end(self._retry_spans.pop(rid), confidence=float(conf[i]))
                if not ok and attempt < self.retry.max_retries:
                    self._retry_q.append((rid, row, attempt + 1, total))
                    if tr is not None:
                        self._retry_spans[rid] = tr.begin(
                            f"retry[{rid}]", parent=lf.lspan, track="retry",
                            attempt=attempt + 1, confidence=float(conf[i]),
                        )
                    if mx is not None:
                        mx.inc(f"retry_attempt_{attempt + 1}")
                    continue
                out[rid] = (post[i], int(accepted[i]))
                emitted.append(rid)
                self.reports[rid] = FrameReport(
                    confidence=float(conf[i]), attempts=attempt + 1,
                    n_bits=n_bits, total_bits=total, reliable=ok,
                    escalation_clamped=clamped,
                )
                self.stats.record_frame(float(conf[i]), attempt, total, ok)
                if mx is not None and not ok:
                    mx.inc("flagged_unreliable")
                if mx is not None and clamped:
                    mx.inc("escalation_clamped")
        if mx is not None:
            mx.inc("frames_out", len(emitted))
            if lf.t_dispatch is not None:
                mx.observe(
                    "launch_ms", (t_now - lf.t_dispatch) * 1e3,
                    budget_ms=PAPER_BUDGET_MS,
                )
            # one dict pop per frame (C-speed map, single lookup), with
            # the arithmetic vectorised: harvest bookkeeping is on the
            # <=5% overhead budget
            waits = [
                t for t in map(self._t_submit.pop, emitted,
                               itertools.repeat(None))
                if t is not None
            ]
            if waits:
                mx.hist("frame_ms", budget_ms=PAPER_BUDGET_MS).observe_many(
                    (t_now - np.asarray(waits)) * 1e3
                )
        if tr is not None:
            tr.end(lf.hspan, emitted=len(emitted))
            tr.end(lf.lspan, ticket=lf.ticket)

    def _zero_post(self) -> np.ndarray:
        """The flagged-unreliable posterior for a frame no launch could serve."""
        q = self.net.query_cards
        if all(c == 2 for c in q):
            return np.zeros((len(q),), np.float32)
        return np.zeros((len(q), max(q)), np.float32)

    def _recover_launch(
        self, lf: _InFlight, exc: Exception, out: Dict[int, Tuple[np.ndarray, int]]
    ) -> None:
        """Restore bookkeeping for one failed launch (never drops a frame).

        Spans are closed with an ``error`` attr, the failure is recorded in
        ``launch_failures`` / ``stats`` / the metrics registry, and every
        frame of the launch is either re-enqueued at the front of its queue
        (fresh entropy on re-dispatch: the launch counter already advanced)
        or, past its ``max_redispatch`` budget, emitted as a flagged zero
        posterior so the caller still sees exactly one terminal result.
        """
        tr, mx = self.trace, self.metrics
        kind = lf.fault or getattr(exc, "kind", None) or "error"
        if tr is not None:
            for sid in (lf.hspan, lf.dspan, lf.lspan):
                if sid is not None and not tr.get(sid).done:
                    tr.end(sid, error=kind)
        self.launch_failures.append(
            LaunchFailure(
                ticket=lf.ticket, kind=kind,
                rids=tuple(item[0] for item in lf.taken),
                attempt=lf.attempt, error=str(exc),
            )
        )
        self.stats.launch_failures += 1
        if mx is not None:
            mx.inc("launch_failures")
            mx.inc(f"launch_failures_{kind}")
        requeue: list = []
        for item in lf.taken:
            rid = item[0]
            if rid in out:   # paranoia: never double-emit or re-enqueue emitted
                continue
            n_fail = self._fail_counts.get(rid, 0) + 1
            self._fail_counts[rid] = n_fail
            if n_fail <= self.max_redispatch:
                requeue.append(item)
                continue
            # redispatch budget exhausted: graceful degradation, never a drop
            self._fail_counts.pop(rid, None)
            out[rid] = (self._zero_post(), 0)
            self.reports[rid] = FrameReport(
                confidence=0.0, attempts=lf.attempt + 1, n_bits=0,
                total_bits=item[3], reliable=False,
            )
            self.stats.record_frame(0.0, lf.attempt, item[3], False)
            self._t_submit.pop(rid, None)
            if mx is not None:
                mx.inc("frames_out")
                mx.inc("fault_exhausted")
        if requeue:
            if mx is not None:
                mx.inc("redispatched_frames", len(requeue))
            if lf.attempt == 0:
                self._queue.extendleft(
                    (rid, row) for rid, row, _, _ in reversed(requeue)
                )
            else:
                self._retry_q.extendleft(reversed(requeue))

    def step(
        self, key: np.ndarray | None = None, block: bool = True
    ) -> Dict[int, Tuple[np.ndarray, int]]:
        """Run one round of batched launches over the queued frames.

        ``block=True`` (default) harvests immediately and returns
        {rid: (posteriors (n_q,), accepted bit count)} for this round (plus
        any still-unharvested async launches).  ``block=False`` only
        *dispatches* -- the launch's device work proceeds asynchronously
        while the caller packs more frames -- and returns ``{}``; collect
        results later with :meth:`harvest`.  ``key=None`` uses the driver's
        own launch-counter key sequence.

        Without a retry policy a round is exactly one launch (one batch off
        the queue).  With one, pending retry batches launch first (one per
        attempt level present, escalated programs), then the main batch; an
        explicit ``key`` covers them all by folding the within-step launch
        index (launch 0 uses ``key`` itself, so the no-retry case is
        unchanged).
        """
        if self.trace is None:
            return self._step_impl(key, block)
        with self.trace.span("step", block=block):
            return self._step_impl(key, block)

    def _step_impl(
        self, key: np.ndarray | None, block: bool
    ) -> Dict[int, Tuple[np.ndarray, int]]:
        if not self._queue and not self._retry_q:
            return self.harvest() if block else {}
        n = 0

        def sub():
            nonlocal n
            k = None if key is None else (
                key if n == 0 else prng.fold_in(key, n)
            )
            n += 1
            return k

        while self._retry_q:
            self._dispatch_retries(sub())
        if self._queue:
            self._dispatch(sub())
        return self.harvest() if block else {}

    def drain(self, key: np.ndarray | None = None) -> Dict[int, Tuple[np.ndarray, int]]:
        """Step until the queue (and any retry backlog) is empty.

        Returns all results keyed by rid.  Any launches previously dispatched
        with ``step(block=False)`` are harvested too, so ``drain`` is always
        the "collect everything" call -- even when the queue itself is
        already empty.
        """
        out: Dict[int, Tuple[np.ndarray, int]] = {}
        while self._queue or self._retry_q:
            if key is None:
                sub = None
            else:
                key, sub = prng.split(key)
            out.update(self.step(sub))
        out.update(self.harvest())
        return out

    def drain_async(
        self, key: np.ndarray | None = None
    ) -> Dict[int, Tuple[np.ndarray, int]]:
        """Pipeline the whole queue: dispatch every launch, then harvest.

        Each launch is dispatched while its predecessors' device work is
        still in flight; the host waits once per harvest round, after
        everything dispatchable is in the air.  Key sequencing
        and rid mapping are identical to :meth:`drain`, so without a retry
        policy the posteriors are bit-identical to the sync path for the same
        ``(base_key, salt)``.  With a retry policy each harvest may re-queue
        under-confidence frames, which pipeline through further rounds until
        none remain; retry-round launch *grouping* differs from ``drain``'s
        (retries batch up across the whole round, and launch keys are drawn
        in a different order), so sync and async posteriors agree only for
        frames that never retried.
        """
        out: Dict[int, Tuple[np.ndarray, int]] = {}
        while self._queue or self._retry_q or self._inflight:
            while self._queue or self._retry_q:
                if key is None:
                    sub = None
                else:
                    key, sub = prng.split(key)
                self.step(sub, block=False)
            out.update(self.harvest())
        return out
