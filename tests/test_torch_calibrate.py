"""The port's calibrate-back loop and keyed sampling against the reference, on the CPU.

* ``compensated_program`` -- integer DAC tables, equal to the reference's
  exactly for every scenario, noise model, cycle and drift-epoch count.
* ``recalibrated_network`` -- the twin's posteriors, decisions and accepted
  counts equal the reference twin's on the same key and frames, fused and
  unfused; a ``mux_mode='rows'`` network recalibrates to the default gather
  lowering, as the reference's does (it passes no ``mux_mode``).
* ``recalibrate_driver`` -- defaults the cycle to ``driver.launches``; clean
  networks refuse.
* ``prng.random_bits`` / ``uniform`` / ``randint`` -- ``jax.random``'s values
  bit for bit under the key layout this jax process uses (``jax.config``).
* ``make_scene``, ``fit_scene_config``, ``calibration_report`` -- the
  reference's scenes bit for bit, and its fitted configs and reports
  exactly (float fields included: the same float32 maps summed by the same
  numpy code).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.bayesnet as R
from repro.data import detection as rdet
import repro_torch.bayesnet as T
from repro_torch.core import prng
from repro_torch.data import detection as tdet

torch.set_num_threads(1)

NAMES = sorted(R.SCENARIOS)
PART = bool(jax.config.jax_threefry_partitionable)   # the key layout of this process
NOISES = {
    "nominal": {},
    "worn": dict(seed=3, wear_tau=2.0, p_stuck_on=0.0, p_stuck_off=0.0),
    "harsh": dict(seed=11, d2d_cv=0.2, read_cv=0.05, ir_drop=0.1, wear_tau=1.0),
}


def _noises(kind):
    return R.NoiseModel(**NOISES[kind]), T.NoiseModel(**NOISES[kind])


def _frames(spec, n, seed):
    r = np.random.default_rng(seed)
    return np.stack([r.integers(0, spec.card(e), n) for e in spec.evidence], 1).astype(np.int32)


def _kd(jkey):
    return np.asarray(jax.random.key_data(jkey))


# ------------------------------------------------------------------ compensation
@pytest.mark.parametrize("kind", sorted(NOISES))
@pytest.mark.parametrize("name", NAMES)
def test_compensated_program_equals_reference(name, kind):
    rn, tn = _noises(kind)
    rspec, tspec = R.by_name(name), T.by_name(name)
    for cycle in (0, 4, 100):
        for epochs in (1, 3):
            want = R.compensated_program(rspec, rn, cycle=cycle, drift_epochs=epochs)
            got = T.compensated_program(tspec, tn, cycle=cycle, drift_epochs=epochs)
            assert got == want, (cycle, epochs)
    # the default cycle is the model's own
    assert T.compensated_program(tspec, tn.with_cycle(7)) == \
        R.compensated_program(rspec, rn.with_cycle(7))


def test_compensated_program_validation():
    spec = T.by_name("lane-change")
    with pytest.raises(ValueError, match="NoiseModel"):
        T.compensated_program(spec, None)
    with pytest.raises(ValueError, match="drift_epochs"):
        T.compensated_program(spec, T.NoiseModel(), drift_epochs=0)


# ------------------------------------------------------------- hot recalibration
RECAL_CASES = [
    ("pedestrian-night", dict(drift_epochs=2), 10),
    ("intersection-cat", {}, 4),
    ("obstacle-class", dict(fused=False), 0),
    ("lane-change", dict(share_entropy=True), 25),
    ("sensor-degradation", dict(mux_mode="rows"), 6),
]


def _pair_nets(name, kw, n_bits=256):
    rn, tn = R.NoiseModel(seed=2, wear_tau=2.0), T.NoiseModel(seed=2, wear_tau=2.0)
    rnet = R.compile_network(R.by_name(name), n_bits, noise=rn, devices=1, **kw)
    tnet = T.compile_network(T.by_name(name), n_bits, noise=tn, device="cpu", **kw)
    return rnet, tnet


@pytest.mark.parametrize("name,kw,cycle", RECAL_CASES)
def test_recalibrated_network_decides_as_reference(name, kw, cycle):
    rnet, tnet = _pair_nets(name, kw)
    rtwin, ttwin = R.recalibrated_network(rnet, cycle), T.recalibrated_network(tnet, cycle)
    assert ttwin.device == tnet.device
    assert ttwin.program == rtwin.program
    assert dataclasses.asdict(ttwin.noise) == dataclasses.asdict(rtwin.noise)
    assert (ttwin.fused, ttwin.share_entropy, ttwin.estimator, ttwin.n_bits,
            ttwin.drift_epochs, ttwin.evidence, ttwin.query_cards) == \
        (rtwin.fused, rtwin.share_entropy, rtwin.estimator, rtwin.n_bits,
         rtwin.drift_epochs, rtwin.evidence, rtwin.query_cards)
    ev = _frames(R.by_name(name), 16, seed=cycle)
    key = jax.random.PRNGKey(cycle + 1)
    want = R.recalibrated_network(rnet, cycle).decide(key, ev)
    got = ttwin.decide(_kd(key), ev)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_rows_network_recalibrates_to_the_gather_lowering():
    # the reference passes no mux_mode, so the twin of a rows network runs
    # the default gather lowering; the port keeps that, pinned here
    rnet, tnet = _pair_nets("sensor-degradation", dict(mux_mode="rows"))
    assert tnet.mux_mode == "rows" and not tnet.fused
    twin = T.recalibrated_network(tnet, 6)
    assert twin.mux_mode == "gather" and not twin.fused
    explicit = T.compile_network(twin.spec, twin.n_bits, fused=False, mux_mode="gather",
                                 noise=twin.noise, program=twin.program, device="cpu")
    ev = _frames(twin.spec, 16, seed=1)
    key = prng.PRNGKey(9)
    for g, w in zip(twin.decide(key, ev), explicit.decide(key, ev)):
        assert torch.equal(g, w)
    rows = T.compile_network(twin.spec, twin.n_bits, fused=False, mux_mode="rows",
                             noise=twin.noise, program=twin.program, device="cpu")
    assert not torch.equal(rows.run(key, ev)[0], twin.run(key, ev)[0])


def test_recalibrated_network_refuses_clean_nets():
    net = T.compile_network(T.by_name("sensor-degradation"), 128, device="cpu")
    with pytest.raises(ValueError, match="noisy network"):
        T.recalibrated_network(net, cycle=5.0)


@pytest.mark.parametrize("cycle", [None, 3])
def test_recalibrate_driver_matches_reference(cycle):
    got = {}
    for pkg, kw, key in ((R, dict(devices=1), jax.random.PRNGKey(11)),
                         (T, dict(device="cpu"), prng.PRNGKey(11))):
        spec = pkg.by_name("sensor-degradation")
        net = pkg.compile_network(spec, 256, noise=pkg.NoiseModel(seed=4, wear_tau=2.0), **kw)
        drv = pkg.FrameDriver(net, max_batch=4, base_key=key, salt=13)
        ev = _frames(spec, 8, seed=2)
        drv.submit(ev)
        out1 = drv.drain()
        launches = drv.launches
        swapped = pkg.recalibrate_driver(drv, cycle)
        assert drv.net is swapped
        assert swapped.noise.cycle == (float(launches) if cycle is None else cycle)
        drv.submit(ev)
        out2 = drv.drain()
        got[pkg] = (launches, swapped.program,
                    {rid: (np.asarray(p), a) for rid, (p, a) in {**out1, **out2}.items()})
    (tl, tp, tout), (rl, rp, rout) = got[T], got[R]
    assert tl == rl > 0 and tp == rp
    assert sorted(tout) == sorted(rout) == list(range(16))
    for rid in rout:
        np.testing.assert_array_equal(tout[rid][0], rout[rid][0])
        assert tout[rid][1] == rout[rid][1]


def test_recalibrate_driver_refuses_clean_driver():
    net = T.compile_network(T.by_name("lane-change"), 128, device="cpu")
    drv = T.FrameDriver(net, max_batch=4, salt=1)
    with pytest.raises(ValueError):
        T.recalibrate_driver(drv)


# ------------------------------------------------------------------ keyed sampling
SHAPES = [(), (1,), (6,), (7,), (3, 5), (2, 64, 64)]


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_random_bits_and_uniform_equal_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for shape in SHAPES:
        want = np.asarray(jax.random.bits(jk, shape))
        got = prng.random_bits(tk, shape, partitionable=PART)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        want = np.asarray(jax.random.uniform(jk, shape))
        got = prng.uniform(tk, shape, partitionable=PART)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        assert np.all((got >= 0) & (got < 1))


# ranges that divide 2**32 and ranges that do not, spans either side of 2**16
# (where the reference's squared multiplier wraps to 0), one value, empty and
# inverted ranges, the int32 ends
RANGES = [(4, 60), (2, 6), (0, 1), (0, 2), (0, 3), (0, 7), (-5, 5), (5, 5), (5, 3),
          (0, 1000), (0, 65536), (0, 65537), (65535, 2 * 65536 + 1), (-7, 2**20 + 3),
          (0, 100_000), (-1000, 1000), (0, 2**31 - 1), (-2**31, 2**31 - 1), (-2**31, -2**31 + 3)]


@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_randint_equals_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for lo, hi in RANGES:
        for shape in ((), (6,), (33,), (4, 9)):
            want = np.asarray(jax.random.randint(jk, shape, lo, hi))
            got = prng.randint(tk, shape, lo, hi, partitionable=PART)
            assert got.shape == want.shape and got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want, err_msg=f"[{lo}, {hi}) {shape}")


def test_randint_one_value_and_overflow():
    k = prng.PRNGKey(3)
    assert np.all(prng.randint(k, (50,), 9, 10, partitionable=PART) == 9)
    assert np.all(prng.randint(k, (50,), 9, 2, partitionable=PART) == 9)
    for lo, hi in ((0, 2**31), (-2**31 - 1, 0)):
        with pytest.raises(OverflowError):
            jax.random.randint(jax.random.PRNGKey(3), (5,), lo, hi)
        with pytest.raises(OverflowError):
            prng.randint(k, (5,), lo, hi)


def test_sampling_under_the_original_key_layout():
    with jax.threefry_partitionable(False):
        jk, tk = jax.random.PRNGKey(5), prng.PRNGKey(5)
        for shape in ((), (1,), (7,), (2, 8, 8)):
            np.testing.assert_array_equal(prng.random_bits(tk, shape, partitionable=False),
                                          np.asarray(jax.random.bits(jk, shape)))
            np.testing.assert_array_equal(prng.randint(tk, shape, 4, 60, partitionable=False),
                                          np.asarray(jax.random.randint(jk, shape, 4, 60)))


# ------------------------------------------------------------------ rollouts
CFGS = [rdet.SceneConfig(), rdet.SceneConfig(night_fraction=0.4791666666, rgb_vis_day=0.93,
                                             strong=0.8512, weak=0.5189),
        rdet.SceneConfig(height=40, width=52, n_obstacles=9, thermal_vis=0.3)]


@pytest.mark.skipif(not PART, reason="the keyed scene splits under the partitionable layout")
@pytest.mark.parametrize("ci", range(len(CFGS)))
def test_make_scene_keyed_equals_reference(ci):
    rcfg = CFGS[ci]
    tcfg = tdet.SceneConfig(**dataclasses.asdict(rcfg))
    nights = set()
    for k in jax.random.split(jax.random.PRNGKey(ci), 12):
        want = rdet.make_scene(k, rcfg)
        got = tdet.make_scene(_kd(k), tcfg, device="cpu")
        for g, w in zip(got[:3], want[:3]):
            w = np.asarray(w)
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
            np.testing.assert_array_equal(g.numpy().view(np.uint32), w.view(np.uint32))
        assert got[3] == bool(want[3])
        nights.add(got[3])
    assert nights == {True, False}


@pytest.mark.skipif(not PART, reason="the keyed scene splits under the partitionable layout")
@pytest.mark.parametrize("seed,n_scenes", [(0, 40), (5, 12), (9, 2)])
def test_fit_scene_config_equals_reference(seed, n_scenes):
    want = R.fit_scene_config(jax.random.PRNGKey(seed), n_scenes=n_scenes)
    got = T.fit_scene_config(prng.PRNGKey(seed), n_scenes=n_scenes, device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.strong > got.weak and want.strong > want.weak


@pytest.mark.skipif(not PART, reason="the keyed scene splits under the partitionable layout")
def test_calibration_report_equals_reference():
    want = R.calibration_report(jax.random.PRNGKey(1), n_scenes=24, repeats=2)
    got = T.calibration_report(prng.PRNGKey(1), n_scenes=24, repeats=2, device="cpu")
    assert got == want
    assert len(got["scenario_dac_deviation"]) == 7
    assert got["max_dac_deviation"] == max(got["scenario_dac_deviation"].values())


def test_rollout_validation():
    with pytest.raises(ValueError, match="n_scenes"):
        T.fit_scene_config(prng.PRNGKey(0), n_scenes=1, device="cpu")
    with pytest.raises(ValueError, match="repeats"):
        T.calibration_report(prng.PRNGKey(0), repeats=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.fit_scene_config(prng.PRNGKey(0), n_scenes=2)   # the card by default
