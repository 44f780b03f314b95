"""The port's BayesRouter on the card (``cuda`` marker).

Needs an NVIDIA GPU with ``nvcc``; every test skips where
``torch.cuda.is_available()`` is False.  The file imports neither JAX nor the
reference package, so it runs on the machine with the card:

    python -m pytest -q -p no:cacheprovider tests/test_torch_cuda_router.py

A router on the card must equal one on the CPU rid for rid (status,
posterior bit for bit, accepted count, degradation level), nominal and under
seeded launch-fault chaos; ``test_torch_router.py`` holds the CPU router
against the JAX reference.  Degradation rungs share their plan's
``net_sweep`` program (no literal depends on n_bits), so they build nothing;
a recalibration re-lowers every rung to one compensated program, one build
(none when the compensation lands exactly on a program already built).
"""

import numpy as np
import pytest
import torch

import repro_torch.bayesnet as T
from repro_torch.core import prng
from repro_torch.distributed.fault import LaunchFaultInjector
from repro_torch.kernels.net_sweep import kernel as K
from repro_torch.serve import BayesRouter, RouterPolicy

torch.set_num_threads(1)

TENANTS = ("sensor-degradation", "pedestrian-night", "intersection-cat")
FAST = dict(backoff_base_s=1e-4, backoff_cap_s=2e-3, breaker_cooldown_s=0.01)
LONG = 600_000.0          # ms: no status may depend on the wall clock
KEY = prng.PRNGKey(42)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _frames(name, n, seed):
    spec = T.by_name(name)
    r = np.random.default_rng(seed)
    return np.stack([r.integers(0, spec.card(e), n) for e in spec.evidence], 1).astype(np.int32)


def _serve(device, n_frames, max_batch, fault=None, **kw):
    r = BayesRouter(RouterPolicy(**FAST), KEY, n_bits=1024, max_batch=max_batch,
                    fault=fault, device=device, **kw)
    rids = []
    for lo in range(0, n_frames, 4):                      # round-robin chunks of 4
        for i, name in enumerate(TENANTS):
            rids += r.submit(name, _frames(name, n_frames, seed=i)[lo:lo + 4],
                             deadline_ms=LONG)
    out = r.drain()
    assert sorted(out) == sorted(rids) == sorted(r.results)   # every rid once, none lost
    return r


def _assert_same(a, b):
    assert sorted(a.results) == sorted(b.results)
    for rid, x in a.results.items():
        y = b.results[rid]
        assert (x.tenant, x.status, x.accepted, x.degrade_level) == \
            (y.tenant, y.status, y.accepted, y.degrade_level), rid
        assert (x.post is None) == (y.post is None)
        if x.post is not None:
            np.testing.assert_array_equal(x.post, y.post)


@pytest.mark.cuda
def test_router_on_the_card_equals_the_cpu(cuda_device):
    launches = K.net_sweep_cuda.launches
    card = _serve(cuda_device, 40, 16)
    torch.cuda.synchronize()
    assert K.net_sweep_cuda.launches > launches
    cpu = _serve("cpu", 40, 16)
    _assert_same(card, cpu)
    assert set(card.status_counts().items()) >= {("OK", 120)}
    for name in TENANTS:
        assert all(d.net.device.type == "cuda" for d in card.tenant(name).drivers.values())


@pytest.mark.cuda
def test_router_under_seeded_chaos_on_the_card_equals_the_cpu(cuda_device):
    chaos = dict(seed=13, p_drop=0.02, p_stall=0.01, p_corrupt=0.02, stall_ms=2.0)
    card = _serve(cuda_device, 24, 1, fault=LaunchFaultInjector(**chaos))
    cpu = _serve("cpu", 24, 1, fault=LaunchFaultInjector(**chaos))
    _assert_same(card, cpu)
    assert card.fault.injected == cpu.fault.injected
    assert min(card.fault.injected.values()) > 0        # drops, stalls and corruptions
    for name in TENANTS:
        assert card.tenant(name).trips == cpu.tenant(name).trips


@pytest.mark.cuda
def test_degraded_rung_builds_nothing_and_recalibration_builds_one(cuda_device):
    name = "lane-change"
    outs = []
    for device in (cuda_device, "cpu"):
        r = BayesRouter(RouterPolicy(capacity=8, max_degrade=1, **FAST), KEY, n_bits=1024,
                        max_batch=8, drift=T.DriftPolicy(warmup=2), device=device)
        builds = K.net_sweep_cuda.builds
        # a noise seed no other test uses: the tenant's plan is a new program
        r.register(name, noise=T.NoiseModel(seed=104_729, cycle=0, wear_tau=1.0))
        for seed in range(3):                                 # depth 4: rung 0, 3 launches
            r.submit(name, _frames(name, 4, seed=seed), deadline_ms=LONG)
            r.drain()
        built_rung0 = K.net_sweep_cuda.builds - builds
        r.submit(name, _frames(name, 12, seed=3), deadline_ms=LONG)   # depth 12: rung 1
        r.drain()
        t = r.tenant(name)
        assert sorted(t.drivers) == [0, 1] and t.drivers[1].net.n_bits == 256
        built_rung1 = K.net_sweep_cuda.builds - builds - built_rung0
        loaded = set(K.BUILDS)
        t.monitor.state = T.HEALTH_RECALIBRATING
        r.submit(name, _frames(name, 4, seed=4), deadline_ms=LONG)
        r.drain()
        built_recal = K.net_sweep_cuda.builds - builds - built_rung0 - built_rung1
        assert t.recalibrations == 1 and r.health(name) == T.HEALTH_HEALTHY
        # the twins of both rungs are one program, fitted at cycle 6 (3 launches on
        # rung 0, 2 on rung 1, then the round that finds the latch); at cycles 3
        # and 4 this tenant's compensation lands exactly on the clean thresholds,
        # so its twin there would be the clean plan's program and build nothing
        twins = {K.program_key(d.net.plan) for d in t.drivers.values()}
        assert len(twins) == 1 and t.drivers[0].net.noise.cycle == 6
        clean = T.compile_network(T.by_name(name), 1024, device="cpu").plan
        assert twins != {K.program_key(clean)}
        if device != "cpu":
            assert twins.isdisjoint(loaded)
            assert (built_rung0, built_rung1, built_recal) == (1, 0, 1)
        else:
            assert (built_rung0, built_rung1, built_recal) == (0, 0, 0)
        outs.append(r)
    _assert_same(*outs)
    assert {res.status for res in outs[0].results.values()} == {"OK", "DEGRADED"}
