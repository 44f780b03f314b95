"""The port's BayesRouter against the reference router, on the CPU.

One parity test per test of the reference's ``tests/serve/test_router.py``:
each runs the same scenario through the reference router and the port's
(``device="cpu"``, the same key data, the same salts and frames) and holds
them equal -- per rid the status, posterior (bit for bit), accepted count,
degradation level and dispatch order -- together with what the scenario is
about: breaker trips and closes, evictions and salts, metrics counters,
retry-clamp reports, recalibrations.

Nothing here depends on wall-clock feasibility: requests the reference test
gives the default 1 s deadline get 600 s here (a slow first compile must not
decide a status), ``latency_ms`` is never compared, and the counters compared
leave out ``router_deadline_miss`` and the watchdog's ``watch_slow_steps``.
The backoff, breaker and chaos paths are deterministic once every frame is
submitted before the drain: the fault injector's verdicts are a pure function
of (seed, salt, ticket), and a gated round dispatches and harvests nothing.
"""

import dataclasses
import functools
import time
import types
import zlib

import jax
import numpy as np
import pytest
import torch

import repro.bayesnet as RB
from repro.bayesnet import reliability as RR
from repro.distributed import fault as RF
from repro import obs as RO
from repro import serve as RS
import repro_torch.bayesnet as TB
from repro_torch.bayesnet import reliability as TR
from repro_torch.core import prng
from repro_torch.distributed import fault as TF
from repro_torch import obs as TO
from repro_torch import serve as TS

torch.set_num_threads(1)

FAST = dict(backoff_base_s=1e-4, backoff_cap_s=2e-3, breaker_cooldown_s=0.01)
LONG = 600_000.0          # ms: a deadline no CPU run comes near
UNTIMED = ("router_deadline_miss", "watch_slow_steps")

REF = types.SimpleNamespace(
    name="reference", B=RB, R=RR, F=RF, O=RO, S=RS, key=jax.random.PRNGKey(42),
    router=RS.BayesRouter, compile=RB.compile_network,
)
PORT = types.SimpleNamespace(
    name="port", B=TB, R=TR, F=TF, O=TO, S=TS, key=prng.PRNGKey(42),
    router=functools.partial(TS.BayesRouter, device="cpu"),
    compile=functools.partial(TB.compile_network, device="cpu"),
)


def _frames(name, n, seed=0):
    spec = RB.by_name(name)
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, size=(n, len(spec.evidence)), dtype=np.int32)


def _results(r, rids=None):
    """Per rid: tenant, status, posterior, accepted, level, dispatch order."""
    rids = sorted(r.results) if rids is None else rids
    out = {}
    for rid in rids:
        res = r.results[rid]
        out[rid] = (res.tenant, res.status,
                    None if res.post is None else np.asarray(res.post),
                    res.accepted, res.degrade_level, r.requests[rid].dispatch_seq)
    return out


def _counters(mx):
    return {k: v for k, v in mx.counters.items() if k not in UNTIMED}


def _equal(a, b, path="record"):
    """Deep equality with numpy arrays compared bit for bit."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def _both(scenario):
    """Run ``scenario(P)`` on the reference and the port; hold them equal."""
    want, got = scenario(REF), scenario(PORT)
    _equal(got, want)
    return got


# --- bit-identity ----------------------------------------------------------------

def test_router_bit_identical_to_standalone_driver():
    def run(P):
        name = "sensor-degradation"
        frames = _frames(name, 6)
        r = P.router(P.S.RouterPolicy(), P.key, n_bits=128, max_batch=4)
        rids = r.submit(name, frames, deadline_ms=LONG)
        res = r.drain()
        d = P.B.FrameDriver(P.compile(P.B.by_name(name), 128), max_batch=4,
                            base_key=P.key, salt=P.S.tenant_salt(name))
        d.submit(frames)
        ref = d.drain()
        for i, rid in enumerate(rids):
            assert res[rid].status == "OK"
            np.testing.assert_array_equal(np.asarray(res[rid].post), np.asarray(ref[i][0]))
            assert res[rid].accepted == ref[i][1]
        return _results(r), P.S.tenant_salt(name)

    _, salt = _both(run)
    assert salt == zlib.crc32(b"sensor-degradation") & 0x7FFFFFFF


def test_tenant_entropy_isolation():
    def run(P):
        frames = _frames("sensor-degradation", 4)
        spec = P.B.by_name("sensor-degradation")
        r = P.router(P.S.RouterPolicy(), P.key, n_bits=128, max_batch=4)
        r.register(spec, salt=1)
        r.register(dataclasses.replace(spec, name="sensor-degradation-b"), salt=2)
        ra = r.submit("sensor-degradation", frames, deadline_ms=LONG)
        rb = r.submit("sensor-degradation-b", frames, deadline_ms=LONG)
        res = r.drain()
        assert any(not np.array_equal(np.asarray(res[a].post), np.asarray(res[b].post))
                   for a, b in zip(ra, rb))
        return _results(r), {n: t.salt for n, t in r._tenants.items()}

    _both(run)


# --- chaos -------------------------------------------------------------------------

# the reference test's case (its seed draws no fault in so few launches), and
# one whose schedule draws faults of every kind
@pytest.mark.parametrize("seed,n_frames,max_batch", [(3, 5, 4), (13, 24, 1)])
def test_chaos_every_frame_terminates_exactly_once(seed, n_frames, max_batch):
    def run(P):
        inj = P.F.LaunchFaultInjector(seed=seed, p_drop=0.02, p_stall=0.01, p_corrupt=0.02,
                                      stall_ms=2.0)
        mx = P.O.MetricsRegistry()
        r = P.router(P.S.RouterPolicy(**FAST), P.key, n_bits=64, max_batch=max_batch,
                     fault=inj, metrics=mx)
        submitted = []
        for i, name in enumerate(["sensor-degradation", "pedestrian-night", "lane-change"]):
            submitted += r.submit(name, _frames(name, n_frames, seed=i), deadline_ms=LONG)
        out = r.drain()
        assert sorted(out) == sorted(submitted) == sorted(r.results)
        assert all(res.status in P.R.TERMINAL_STATUSES for res in out.values())
        assert sum(r.status_counts().values()) == len(submitted)
        trips = {n: (t.trips, t.consecutive_failures) for n, t in r._tenants.items()}
        return _results(r), dict(inj.injected), _counters(mx), trips, r.status_counts()

    _, injected, *_ = _both(run)
    if seed == 13:
        assert min(injected.values()) > 0      # drops, stalls and corruptions


def test_total_device_failure_still_terminates():
    def run(P):
        inj = P.F.LaunchFaultInjector(seed=0, p_drop=1.0)
        r = P.router(P.S.RouterPolicy(max_redispatch=1, breaker_threshold=2, **FAST),
                     P.key, n_bits=64, max_batch=4, fault=inj)
        rids = r.submit("sensor-degradation", _frames("sensor-degradation", 4),
                        deadline_ms=LONG)
        out = r.drain()
        assert sorted(out) == rids
        for rid in rids:
            assert out[rid].status == "UNRELIABLE" and out[rid].accepted == 0
        t = r.tenant("sensor-degradation")
        return _results(r), t.trips, dict(inj.injected)

    _both(run)


# --- deadline-aware admission ----------------------------------------------------

def test_expired_deadline_sheds_rejected_immediately():
    def run(P):
        r = P.router(P.S.RouterPolicy(), P.key, n_bits=64, max_batch=4)
        rids = r.submit("sensor-degradation", _frames("sensor-degradation", 3),
                        deadline_ms=-1.0)
        for rid in rids:
            assert r.results[rid].status == "REJECTED" and r.results[rid].post is None
        assert r.pending == 0
        assert r.drain() == {rid: r.results[rid] for rid in rids}
        return _results(r), [r.results[rid].deadline_met for rid in rids]

    _both(run)


def test_pending_queue_is_deadline_ordered_not_fifo():
    def run(P):
        r = P.router(P.S.RouterPolicy(), P.key, n_bits=64, max_batch=1)
        fr = _frames("sensor-degradation", 1)
        late = r.submit("sensor-degradation", fr, deadline_ms=60_000)[0]
        soon = r.submit("sensor-degradation", fr, deadline_ms=10_000)[0]
        r.drain()
        assert r.requests[soon].dispatch_seq < r.requests[late].dispatch_seq
        return _results(r)

    _both(run)


def test_infeasible_request_sheds_instead_of_queuing():
    def run(P):
        r = P.router(P.S.RouterPolicy(**FAST), P.key, n_bits=64, max_batch=4)
        name = r.register("sensor-degradation")
        r.tenant(name).breaker_open_until = time.perf_counter() + 30.0
        rids = r.submit(name, _frames(name, 2), deadline_ms=50.0)
        assert all(r.results[rid].status == "REJECTED" for rid in rids)
        return _results(r), r.pending

    _both(run)


# --- graceful degradation --------------------------------------------------------

def test_overload_degrades_along_nbits_ladder():
    def run(P):
        pol = P.S.RouterPolicy(capacity=2, max_degrade=2, min_n_bits=32, **FAST)
        r = P.router(pol, P.key, n_bits=512, max_batch=4)
        name = "sensor-degradation"
        rids = r.submit(name, _frames(name, 9), deadline_ms=LONG)
        out = r.drain()
        t = r.tenant(name)
        assert max(out[rid].degrade_level for rid in rids) == 2
        assert all(out[rid].status == "DEGRADED" for rid in rids)
        assert t.n_bits_for(1) == 128 and t.n_bits_for(2) == 32
        rungs = {lv: (d.net.n_bits, d.salt, d.launches) for lv, d in t.drivers.items()}
        for lv, (n_bits, _, _) in rungs.items():
            assert n_bits == t.n_bits_for(lv)
        return _results(r), rungs

    _both(run)


def test_nominal_load_never_degrades():
    def run(P):
        r = P.router(P.S.RouterPolicy(), P.key, n_bits=64, max_batch=4)
        rids = r.submit("sensor-degradation", _frames("sensor-degradation", 4),
                        deadline_ms=LONG)
        out = r.drain()
        assert all(out[rid].status == "OK" and out[rid].degrade_level == 0 for rid in rids)
        return _results(r)

    _both(run)


def test_degrade_ladder_floors_and_collapses():
    def run(P):
        pol = P.S.RouterPolicy(capacity=1, max_degrade=2, min_n_bits=128, **FAST)
        r = P.router(pol, P.key, n_bits=128, max_batch=4)
        t = r.tenant(r.register("sensor-degradation"))
        _, eff = t.driver(2)
        assert eff == 0 and list(t.drivers) == [0]
        return eff, [t.n_bits_for(lv) for lv in range(4)]

    _both(run)


# --- failure response ------------------------------------------------------------

def _switchable(P):
    class Switchable(P.F.LaunchFaultInjector):
        """Chaos with an off switch: drop everything while ``on`` is set."""

        def __init__(self):
            super().__init__()
            self.on = True

        def draw(self, *ids):
            if self.on:
                self.injected["drop"] += 1
                return "drop"
            return None

    return Switchable()


def test_breaker_trips_then_recovers():
    def run(P):
        inj = _switchable(P)
        mx = P.O.MetricsRegistry()
        r = P.router(P.S.RouterPolicy(breaker_threshold=2, max_redispatch=2, **FAST),
                     P.key, n_bits=64, max_batch=4, fault=inj, metrics=mx)
        name = "sensor-degradation"
        bad = r.submit(name, _frames(name, 3), deadline_ms=LONG)
        out = r.drain()
        t = r.tenant(name)
        assert t.trips >= 1 and mx.count("router_breaker_trips") == t.trips
        assert all(out[rid].status == "UNRELIABLE" for rid in bad)
        first = (t.trips, t.consecutive_failures, _counters(mx))
        inj.on = False
        good = r.submit(name, _frames(name, 3, seed=1), deadline_ms=LONG)
        out = r.drain()
        assert all(out[rid].status == "OK" for rid in good)
        assert not t.breaker_open and t.consecutive_failures == 0
        assert mx.count("router_breaker_closes") >= 1
        return _results(r), first, _counters(mx), t.trips

    _both(run)


def test_backoff_gates_redispatch():
    def run(P):
        r = P.router(P.S.RouterPolicy(**FAST), P.key, n_bits=64, max_batch=4)
        name = r.register("sensor-degradation")
        t = r.tenant(name)
        t.consecutive_failures = 3
        t.not_before = time.perf_counter() + 30.0
        rids = r.submit(name, _frames(name, 2), deadline_ms=120_000)
        r.pump()
        assert all(r.requests[rid].dispatch_seq == -1 for rid in rids)
        assert r.pending == 2
        t.not_before = 0.0
        out = r.drain()
        assert all(out[rid].status == "OK" for rid in rids)
        return _results(r), t.consecutive_failures

    _both(run)


# --- plan cache / tenants --------------------------------------------------------

def test_lru_evicts_idle_tenants_only_and_salts_persist():
    def run(P):
        mx = P.O.MetricsRegistry()
        r = P.router(P.S.RouterPolicy(), P.key, n_bits=64, max_batch=4,
                     max_cached_tenants=2, metrics=mx)
        r.register("sensor-degradation", salt=123)
        r.register("pedestrian-night")
        r.register("lane-change")
        cached = [list(r._tenants)]
        assert "sensor-degradation" not in r._tenants
        r.submit("pedestrian-night", _frames("pedestrian-night", 2), deadline_ms=LONG)
        r._admit(time.perf_counter())
        r.register("intersection")
        cached.append(list(r._tenants))
        assert "pedestrian-night" in r._tenants and "lane-change" not in r._tenants
        r.drain()
        r.register("sensor-degradation")
        assert r.tenant("sensor-degradation").salt == 123
        cached.append(list(r._tenants))
        return _results(r), cached, dict(r._salts), _counters(mx)

    _both(run)


def test_harvest_pops_fresh_results_once():
    def run(P):
        r = P.router(P.S.RouterPolicy(), P.key, n_bits=64, max_batch=4)
        rids = r.submit("sensor-degradation", _frames("sensor-degradation", 2),
                        deadline_ms=LONG)
        out = r.drain()
        assert sorted(out) == rids and r.harvest() == {} and sorted(r.results) == rids
        return _results(r)

    _both(run)


def test_policy_validation():
    for P in (REF, PORT):
        for kw, match in ((dict(deadline_mult=0), "deadline_mult"),
                          (dict(capacity=0), "capacity"),
                          (dict(degrade_step=1), "degrade_step"),
                          (dict(max_degrade=-1), "max_degrade"),
                          (dict(breaker_threshold=0), "breaker_threshold")):
            with pytest.raises(ValueError, match=match):
                P.S.RouterPolicy(**kw)
        with pytest.raises(ValueError, match="max_cached_tenants"):
            P.router(max_cached_tenants=0)
        with pytest.raises(TypeError, match="drift"):
            P.router(drift=object())
    assert TS.RouterPolicy().default_deadline_s == RS.RouterPolicy().default_deadline_s == 1.0
    assert dataclasses.asdict(TS.RouterPolicy()) == dataclasses.asdict(RS.RouterPolicy())


def test_router_defaults_to_the_card():
    # without a card the default device raises instead of serving on the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TS.BayesRouter()
    r = TS.BayesRouter(device="cpu")
    np.testing.assert_array_equal(r.base_key, np.asarray(jax.random.key_data(
        jax.random.PRNGKey(0))))
    assert r.base_key.dtype == np.uint32 and r.device.type == "cpu"
    r.submit("lane-change", _frames("lane-change", 2), deadline_ms=LONG)
    r.drain()
    assert all(d.net.device.type == "cpu" for d in r.tenant("lane-change").drivers.values())


def test_metrics_and_status_accounting():
    def run(P):
        mx = P.O.MetricsRegistry()
        r = P.router(P.S.RouterPolicy(), P.key, n_bits=64, max_batch=4, metrics=mx)
        name = "sensor-degradation"
        rids = r.submit(name, _frames(name, 3), deadline_ms=LONG)
        r.submit(name, _frames(name, 1), deadline_ms=-1.0)
        r.drain()
        assert mx.count("router_submitted") == 4 and mx.count("router_ok") == 3
        assert mx.count("router_rejected") == 1
        assert f"router_{name}_frame_ms" in mx.histograms
        counts = r.status_counts()
        assert counts["OK"] == 3 and counts["REJECTED"] == 1
        assert all(r.results[rid].deadline_met for rid in rids)
        hist = mx.histograms[f"router_{name}_frame_ms"]
        return _results(r), counts, _counters(mx), sorted(mx.histograms), sum(hist.counts)

    _both(run)


# --- crossbar health: retry clamp, drift monitor, recalibration -------------------

def test_degraded_rung_clamps_retry_escalation():
    def run(P):
        pol = P.S.RouterPolicy(capacity=2, max_degrade=2, min_n_bits=32, **FAST)
        r = P.router(pol, P.key, n_bits=512, max_batch=4,
                     retry=P.R.RetryPolicy(min_confidence=0.9999, max_retries=2,
                                           escalation=4, max_n_bits=1 << 16))
        name = "sensor-degradation"
        r.submit(name, _frames(name, 9), deadline_ms=LONG)
        r.drain()
        t = r.tenant(name)
        assert any(level > 0 for level in t.drivers)
        clamped, reports = [], {}
        for level, drv in t.drivers.items():
            reports[level] = {rid: dataclasses.asdict(rep) for rid, rep in drv.reports.items()}
            if level == 0:
                assert drv.retry.max_n_bits == 1 << 16
                continue
            assert drv.retry.max_n_bits == t.n_bits_for(level)
            for rep in drv.reports.values():
                assert rep.n_bits <= t.n_bits_for(level)
                if rep.attempts > 1:
                    clamped.append(rep)
        assert clamped and all(rep.escalation_clamped for rep in clamped)
        return _results(r), reports

    _both(run)


def _noisy_router(P, name, **kw):
    r = P.router(P.S.RouterPolicy(**FAST), P.key, n_bits=256, max_batch=8,
                 drift=P.B.DriftPolicy(warmup=2), **kw)
    r.register(name, noise=P.B.NoiseModel(seed=9, cycle=0, wear_tau=1.0))
    return r


def test_drift_monitor_auto_recalibrates_tenant():
    def run(P):
        name = "pedestrian-night"
        mx = P.O.MetricsRegistry()
        r = _noisy_router(P, name, metrics=mx)
        assert r.health(name) == "HEALTHY"
        rids = list(r.submit(name, _frames(name, 8), deadline_ms=LONG))
        r.drain()
        t = r.tenant(name)
        assert t.monitor.launches >= 1
        before = t.monitor.as_dict()
        t.monitor.state = P.R.HEALTH_RECALIBRATING
        rids.extend(r.submit(name, _frames(name, 8, seed=1), deadline_ms=LONG))
        r.drain()
        assert t.recalibrations == 1 and r.health(name) == "HEALTHY"
        assert sorted(r.results) == sorted(rids)
        assert all(r.results[rid].status == "OK" for rid in rids)
        assert all(d.net.program is not None for d in t.drivers.values())
        programs = {lv: (d.net.program, d.net.noise.cycle) for lv, d in t.drivers.items()}
        return (_results(r), before, t.monitor.as_dict(), programs, t.cycle_estimate(),
                _counters(mx))

    _both(run)


def test_manual_recalibrate_and_clean_tenant_refuses():
    def run(P):
        r = P.router(P.S.RouterPolicy(**FAST), P.key, n_bits=128, max_batch=4,
                     drift=P.B.DriftPolicy(warmup=64))
        noisy = "lane-change"
        r.register(noisy, noise=P.B.NoiseModel(seed=4, wear_tau=2.0))
        r.submit(noisy, _frames(noisy, 4), deadline_ms=LONG)
        r.drain()
        t = r.tenant(noisy)
        cycle = r.recalibrate(noisy)
        assert t.recalibrations == 1 and cycle == t.cycle_estimate()
        post_swap = r.submit(noisy, _frames(noisy, 4, seed=2), deadline_ms=LONG)
        r.drain()
        clean = r.register("intersection")
        with pytest.raises(ValueError):
            r.recalibrate(clean)
        r2 = P.router(P.S.RouterPolicy(**FAST), P.key, n_bits=128, max_batch=4)
        r2.register("intersection")
        assert r2.health("intersection") == "HEALTHY"
        assert r2.tenant("intersection").monitor is None
        return _results(r), cycle, _results(r, post_swap), t.drivers[0].net.program

    _both(run)


def test_auto_recalibrate_off_leaves_latch_visible():
    def run(P):
        name = "pedestrian-night"
        r = _noisy_router(P, name, auto_recalibrate=False)
        r.submit(name, _frames(name, 8), deadline_ms=LONG)
        r.drain()
        t = r.tenant(name)
        t.monitor.state = P.R.HEALTH_RECALIBRATING
        r.submit(name, _frames(name, 8, seed=1), deadline_ms=LONG)
        r.drain()
        assert t.recalibrations == 0 and r.health(name) == "RECALIBRATING"
        return _results(r), t.monitor.as_dict()

    _both(run)
