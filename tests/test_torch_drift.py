"""The port's FrameDriver drift feed and hot swap against the reference, on the CPU.

``FrameDriver(drift=DriftMonitor(...))`` folds every harvested launch's mean
decision confidence and accept rate into the monitor's CUSUM detectors.  The
monitors here record what each launch fed them and their state after it;
the port's trajectory must equal the reference's launch for launch: the same
statistics, CUSUM scores, EWMAs and health states, exactly.  The hot swap to
a calibrate-back twin (``swap_net(recalibrated_network(...))``) with
launches in flight must give the reference's posteriors rid for rid.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.bayesnet as R
import repro_torch.bayesnet as T
from repro_torch.core import prng

torch.set_num_threads(1)

BASE, SALT = 5, 41
POLICY = dict(warmup=4, drift_h=0.5, recal_h=2.0)   # low limits: the states move


def _frames(spec, n, seed):
    r = np.random.default_rng(seed)
    return np.stack([r.integers(0, spec.card(e), n) for e in spec.evidence], 1).astype(np.int32)


def _recording(pkg):
    class Recording(pkg.DriftMonitor):
        """A monitor that keeps, per launch, what it was fed and its snapshot."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.trajectory = []

        def observe_launch(self, confidence, accept_rate, flip=None):
            state = super().observe_launch(confidence, accept_rate, flip)
            self.trajectory.append((confidence, accept_rate, state, self.as_dict()))
            return state

    return Recording


def _noise(pkg, noisy):
    return pkg.NoiseModel(seed=9, cycle=3, wear_tau=1.0) if noisy else None


def _drive(pkg, name, noisy, mode, device_kw, n_frames=40):
    spec = pkg.by_name(name)
    net = pkg.compile_network(spec, 256, noise=_noise(pkg, noisy), **device_kw)
    mon = _recording(pkg)(pkg.DriftPolicy(**POLICY))
    key = (jax.random.PRNGKey(BASE) if pkg is R else prng.PRNGKey(BASE))
    drv = pkg.FrameDriver(net, max_batch=4, base_key=key, salt=SALT, drift=mon)
    drv.submit(_frames(spec, n_frames, seed=7))
    out = drv.drain_async() if mode == "async" else drv.drain()
    return drv, mon, out


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("name,noisy", [("pedestrian-night", True), ("intersection-cat", False),
                                        ("sensor-degradation", True)])
def test_driver_drift_trajectory_matches_reference(name, noisy, mode):
    rdrv, rmon, rout = _drive(R, name, noisy, mode, {})
    tdrv, tmon, tout = _drive(T, name, noisy, mode, {"device": "cpu"})
    assert sorted(tout) == sorted(rout)
    for rid in rout:
        np.testing.assert_array_equal(tout[rid][0], np.asarray(rout[rid][0]))
        assert tout[rid][1] == rout[rid][1]
    assert tmon.launches == rmon.launches == tdrv.launches == rdrv.launches == 10
    assert len(tmon.trajectory) == len(rmon.trajectory) == 10
    for t, r in zip(tmon.trajectory, rmon.trajectory):
        assert t == r                    # statistics, scores, EWMAs, state: exact
    states = {s for _, _, s, _ in tmon.trajectory}
    assert states != {T.HEALTH_HEALTHY} or not noisy   # the limits make the states move


def test_monitor_reset_and_shared_monitor_match_reference():
    # two drivers feeding one monitor (as the router's rungs do), reset midway
    got = {}
    for pkg, kw in ((R, {}), (T, {"device": "cpu"})):
        spec = pkg.by_name("lane-change")
        mon = _recording(pkg)(pkg.DriftPolicy(**POLICY))
        key = jax.random.PRNGKey(BASE) if pkg is R else prng.PRNGKey(BASE)
        drvs = [pkg.FrameDriver(pkg.compile_network(spec, n, **kw), max_batch=4,
                                base_key=key, salt=SALT + i, drift=mon)
                for i, n in enumerate((256, 64))]
        for i, d in enumerate(drvs):
            d.submit(_frames(spec, 16, seed=i))
            d.drain()
        mon.reset()
        for d in drvs:
            d.submit(_frames(spec, 8, seed=3))
            d.drain()
        got[pkg] = (mon.trajectory, mon.as_dict())
    assert got[T] == got[R]


def _swap_run(pkg, kw):
    spec = pkg.by_name("pedestrian-night")
    noise = pkg.NoiseModel(seed=2, cycle=0, wear_tau=2.0)
    net = pkg.compile_network(spec, 512, noise=noise, drift_epochs=2, **kw)
    key = jax.random.PRNGKey(BASE) if pkg is R else prng.PRNGKey(BASE)
    mon = _recording(pkg)(pkg.DriftPolicy(**POLICY))
    drv = pkg.FrameDriver(net, max_batch=4, base_key=key, salt=77, drift=mon)
    ev = _frames(spec, 12, seed=5)
    drv.submit(ev[:8])
    drv.step(block=False)
    drv.step(block=False)                 # two launches in flight
    twin = pkg.recalibrated_network(net, cycle=drv.launches)
    drv.swap_net(twin)
    out = drv.harvest()
    rids = drv.submit(ev[8:])
    out.update(drv.drain())
    return out, rids, drv, twin, mon


def test_hot_swap_to_recalibrated_twin_matches_reference():
    rout, rrids, rdrv, rtwin, rmon = _swap_run(R, {})
    tout, trids, tdrv, ttwin, tmon = _swap_run(T, {"device": "cpu"})
    assert sorted(tout) == sorted(rout) == list(range(12))       # zero lost frames
    assert trids == rrids
    for rid in rout:
        np.testing.assert_array_equal(tout[rid][0], np.asarray(rout[rid][0]))
        assert tout[rid][1] == rout[rid][1]
    assert tdrv.net is ttwin and rdrv.net is rtwin
    assert ttwin.program == rtwin.program
    assert dataclasses.asdict(ttwin.noise) == dataclasses.asdict(rtwin.noise)
    assert ttwin.drift_epochs == rtwin.drift_epochs == 2
    assert tmon.trajectory == rmon.trajectory
