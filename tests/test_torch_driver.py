"""The port's FrameDriver against the reference driver, on the CPU.

Both drivers get the same base key, the same explicit ``salt`` and the same
numpy-seeded frames; per-rid posteriors and accepted counts must be equal
bit for bit.  Every reference driver here takes an explicit ``salt`` so that
the reference's process-wide default-salt counter does not move for other
tests in the same process.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import repro.bayesnet as R
from repro.bayesnet import driver as rdriver
from repro.distributed.fault import LaunchFaultInjector as RInjector
import repro_torch.bayesnet as T
from repro_torch.bayesnet import driver as tdriver
from repro_torch.core import prng
from repro_torch.distributed.fault import LaunchFaultInjector as TInjector
from repro_torch.obs import MetricsRegistry, Tracer

torch.set_num_threads(1)

NAMES = sorted(R.SCENARIOS)
N_BITS, MAX_BATCH, N_FRAMES, SALT, BASE = 256, 8, 21, 29, 7


def _frames(name, n=N_FRAMES, seed=3):
    spec = R.by_name(name)
    r = np.random.default_rng(seed)
    cols = [r.integers(0, spec.card(e), n) for e in spec.evidence]
    return np.stack(cols, 1).astype(np.int32)


def _tnoise(noise):
    return None if noise is None else T.NoiseModel(**dataclasses.asdict(noise))


@functools.lru_cache(maxsize=None)
def _rnet(name, n_bits=N_BITS, noise=None):
    return R.compile_network(R.by_name(name), n_bits=n_bits, noise=noise)


def _tnet(name, n_bits=N_BITS, noise=None):
    return T.compile_network(T.by_name(name), n_bits=n_bits, noise=_tnoise(noise),
                             device="cpu")


def _rdriver(name, **kw):
    kw.setdefault("salt", SALT)
    return R.FrameDriver(_rnet(name), max_batch=MAX_BATCH,
                         base_key=jax.random.PRNGKey(BASE), **kw)


def _tdriver(name, **kw):
    kw.setdefault("salt", SALT)
    return T.FrameDriver(_tnet(name), max_batch=MAX_BATCH,
                         base_key=prng.PRNGKey(BASE), **kw)


def _reports(d):
    return {rid: dataclasses.asdict(r) for rid, r in d.reports.items()}


def _assert_same(tout, rout):
    assert sorted(tout) == sorted(rout)
    for rid, (post, acc) in rout.items():
        tpost, tacc = tout[rid]
        assert isinstance(tpost, np.ndarray) and tpost.dtype == np.float32
        np.testing.assert_array_equal(tpost, np.asarray(post))
        assert tacc == acc


@functools.lru_cache(maxsize=None)
def _reference_drain(name):
    d = _rdriver(name)
    d.submit(_frames(name))
    return d.drain()


@pytest.mark.parametrize("name", NAMES)
def test_sync_drain_matches_reference(name):
    d = _tdriver(name)
    d.submit(_frames(name))
    _assert_same(d.drain(), _reference_drain(name))
    assert d.launches == 3 and d.last_launch_shape == (8, len(R.by_name(name).evidence))


@pytest.mark.parametrize("name", NAMES)
def test_async_drain_matches_reference(name):
    d = _tdriver(name)
    d.submit(_frames(name))
    _assert_same(d.drain_async(), _reference_drain(name))
    assert d.in_flight == 0


@pytest.mark.parametrize("name", ["intersection-cat", "pedestrian-night"])
def test_explicit_step_keys_match_reference(name):
    rd, td = _rdriver(name), _tdriver(name)
    rd.submit(_frames(name, 13))
    td.submit(_frames(name, 13))
    rout, tout = {}, {}
    for i in range(2):
        rout.update(rd.step(jax.random.PRNGKey(100 + i), block=False))
        tout.update(td.step(prng.PRNGKey(100 + i), block=False))
    rout.update(rd.harvest())
    tout.update(td.harvest())
    _assert_same(tout, rout)


@pytest.mark.parametrize("name", ["lane-change", "obstacle-class"])
def test_retry_drain_matches_reference(name):
    kw = dict(retry=R.RetryPolicy(min_confidence=0.95, max_retries=2, escalation=2))
    rd = _rdriver(name, **kw)
    td = _tdriver(name, retry=T.RetryPolicy(min_confidence=0.95, max_retries=2,
                                            escalation=2))
    rd.submit(_frames(name, 12))
    td.submit(_frames(name, 12))
    _assert_same(td.drain(), rd.drain())
    assert _reports(td) == _reports(rd)
    # every statistic but the wall-clock watchdog's slow-launch count
    tstats, rstats = dataclasses.asdict(td.stats), dataclasses.asdict(rd.stats)
    tstats.pop("slow_launches")
    rstats.pop("slow_launches")
    assert tstats == rstats
    assert any(r["attempts"] > 1 for r in _reports(td).values())


@pytest.mark.parametrize("name", ["intersection", "sensor-degradation"])
def test_seeded_chaos_drain_matches_reference(name):
    rates = dict(seed=5, p_drop=0.25, p_corrupt=0.25, p_stall=0.0)
    rd = _rdriver(name, fault=RInjector(**rates), max_redispatch=2)
    td = _tdriver(name, fault=TInjector(**rates), max_redispatch=2)
    rd.submit(_frames(name))
    td.submit(_frames(name))
    _assert_same(td.drain(), rd.drain())
    assert [(f.ticket, f.kind, f.rids) for f in td.launch_failures] == \
        [(f.ticket, f.kind, f.rids) for f in rd.launch_failures]
    assert td.launch_failures and _reports(td) == _reports(rd)


def test_swap_net_mid_stream_matches_reference():
    name = "obstacle-detection"
    noise = R.NoiseModel.nominal()
    rd, td = _rdriver(name), _tdriver(name)
    rd.submit(_frames(name))
    td.submit(_frames(name))
    rout = rd.step(block=False)
    tout = td.step(block=False)
    rd.swap_net(_rnet(name, noise=noise))
    td.swap_net(_tnet(name, noise=noise))
    rout.update(rd.drain())
    tout.update(td.drain())
    _assert_same(tout, rout)
    with pytest.raises(ValueError):
        td.swap_net(_tnet("lane-change"))
    with pytest.raises(TypeError):
        td.swap_net("not a network")


def test_traced_driver_is_bit_identical_and_spans_the_launch():
    name = "pedestrian-night"
    tr = Tracer()
    d = _tdriver(name, trace=tr, metrics=MetricsRegistry())
    d.submit(_frames(name))
    _assert_same(d.drain_async(), _reference_drain(name))
    names = [s.name for s in tr.spans]
    for want in ("launch[0]", "pack", "dispatch", "device", "harvest", "step"):
        assert want in names
    assert all(s.done for s in tr.spans)
    m = d.metrics.as_dict()
    assert m["counters"]["frames_in"] == m["counters"]["frames_out"] == N_FRAMES
    assert m["counters"]["launches"] == 3


def test_default_salts_use_the_ports_own_counter():
    before = repr(rdriver._DRIVER_IDS)
    a = T.FrameDriver(_tnet("lane-change"))
    b = T.FrameDriver(_tnet("lane-change"))
    assert b.salt == a.salt + 1
    assert repr(rdriver._DRIVER_IDS) == before
    assert tdriver._DRIVER_IDS is not rdriver._DRIVER_IDS


def test_driver_takes_the_networks_device_and_never_falls_back():
    net = _tnet("lane-change")
    assert T.FrameDriver(net, salt=1).net.device.type == "cpu"
    cuda_net = dataclasses.replace(net, device=torch.device("cuda"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.FrameDriver(cuda_net, salt=1)
    with pytest.raises(ValueError):
        T.FrameDriver(net, max_batch=0, salt=1)
