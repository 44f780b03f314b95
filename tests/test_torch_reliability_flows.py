"""The reliable decision path's flows against the JAX reference, on the CPU.

``chip_smoke.py``'s ``reliability`` and ``drift`` phases run the reference's
reliability flows (``benchmarks/bench_reliability.py``, ``bench_drift.py``)
on the card and hold each against its own run on ``device="cpu"``.  Here the
same flow functions, imported from ``chip_smoke.py`` and called with
``device="cpu"`` at reduced sizes, are held against the flows written with
``repro.bayesnet`` calls: posteriors, accepted counts, decisions, flip rates,
``ReliabilityStats``, retry reports, the aging race's trajectory rows and the
drift monitor's snapshots, bit for bit (``chip_smoke.held_equal``); the
oracles' posteriors within atol 5e-7 (float32 sums in another order).
"""

import dataclasses
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

import repro.bayesnet as R

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)

FRAMES = 64                                   # evidence frames per flow (512 / 128 on the card)
FLIP_SIZES = dict(scales=cs.REL_SCALES, scale_bits=512, n_bits=(256, 512))
RACE_SIZES = dict(n_bits=512, batch=FRAMES, launches=3, final_repeats=2)
ORACLE_ATOL = 5e-7


def _host(x):
    return np.asarray(x)


def ref_flip_curves(name, frames, scales, scale_bits, n_bits):
    spec = R.by_name(name)
    ev = R.sample_evidence(spec, jax.random.PRNGKey(1), frames)
    exact, _ = R.make_posterior_fn(spec, dac_quantize=True)(ev)
    ref = _host(R.posterior_argmax(exact))
    nominal, key = R.NoiseModel.nominal(), jax.random.PRNGKey(0)

    def decide(nb, noise):
        post, dec, acc = (_host(t) for t in
                          R.compile_network(spec, n_bits=nb, noise=noise).decide(key, ev))
        return {"post": post, "dec": dec, "accepted": acc, "flip": R.flip_rate(dec, ref)}

    by_scale = {s: decide(scale_bits, None if s == 0 else nominal.scaled(s)) for s in scales}
    by_bits = {nb: by_scale[1.0] if nb == scale_bits and 1.0 in by_scale else decide(nb, nominal)
               for nb in n_bits}
    return {"ref": ref, "scale": by_scale, "n_bits": by_bits, "meta": {"oracle": _host(exact)}}


def _ref_drained(drv, ev, mode="sync"):
    rids = drv.submit(ev)
    out = drv.drain_async() if mode == "async" else drv.drain()
    assert sorted(out) == rids
    return rids, {r: (_host(out[r][0]), out[r][1]) for r in out}


def ref_retry_race(name, mode, frames):
    spec = R.by_name(name)
    nominal = R.NoiseModel.nominal()
    ev = _host(R.sample_evidence(spec, jax.random.PRNGKey(1), frames))
    exact, _ = R.make_posterior_fn(spec, noise=nominal)(ev)
    ref = _host(R.posterior_argmax(exact))

    def serve(n_bits, retry):
        drv = R.FrameDriver(R.compile_network(spec, n_bits=n_bits, noise=nominal),
                            max_batch=frames, salt=0, retry=retry)
        rids, out = _ref_drained(drv, ev, mode)
        post = np.stack([out[r][0] for r in rids])
        dec = _host(R.posterior_argmax(post))
        return drv, {"post": post, "accepted": np.asarray([out[r][1] for r in rids]),
                     "dec": dec, "flip": R.flip_rate(dec, ref)}

    drv, retried = serve(cs.REL_RETRY_BITS, R.RetryPolicy(**cs.REL_RETRY))
    flat_bits = int(-(-drv.stats.mean_bits // 32) * 32)
    _, flat = serve(flat_bits, None)
    stats = {k: v for k, v in dataclasses.asdict(drv.stats).items() if k != "slow_launches"}
    return {"ref": ref, "retry": retried, "flat": flat, "flat_bits": flat_bits, "stats": stats,
            "overhead": drv.stats.mean_bits / cs.REL_RETRY_BITS,
            "reports": {rid: dataclasses.asdict(r) for rid, r in sorted(drv.reports.items())},
            "meta": {"oracle": _host(exact)}}


def ref_aging_race(name, n_bits, batch, launches, final_repeats):
    spec = R.by_name(name)
    nm = R.NoiseModel(**cs.DRIFT_NOISE)
    ev = _host(R.sample_evidence(spec, jax.random.PRNGKey(3), batch))
    exact, _ = R.make_posterior_fn(spec, dac_quantize=True)(ev)
    ref = _host(R.posterior_argmax(exact))

    def plan(cycle, program_cycle=None):
        prog = None if program_cycle is None else R.compensated_program(
            spec, nm.with_cycle(program_cycle), drift_epochs=cs.DRIFT_EPOCHS)
        return R.compile_network(spec, n_bits, noise=nm.with_cycle(cycle),
                                 drift_epochs=cs.DRIFT_EPOCHS, program=prog, devices=1)

    drv_open = R.FrameDriver(plan(0), max_batch=batch, salt=cs.DRIFT_SALT)
    drv_closed = R.FrameDriver(plan(0, 0), max_batch=batch, salt=cs.DRIFT_SALT)
    recals, prog_cycle, rows, posts = 1, 0, [], []
    for i in range(launches):
        cycle = i * cs.DRIFT_CYCLE_STEP
        if i > 0:
            drv_open.swap_net(plan(cycle))
            if i % cs.DRIFT_RECAL_EVERY == 0:
                prog_cycle = cycle
                recals += 1
            drv_closed.swap_net(plan(cycle, prog_cycle))
        reps = final_repeats if i == launches - 1 else 1
        flip_open = flip_closed = 0.0
        for _ in range(reps):
            rids, out = _ref_drained(drv_open, ev)
            po = np.stack([out[r][0] for r in rids])
            rids, out = _ref_drained(drv_closed, ev)
            pc = np.stack([out[r][0] for r in rids])
            flip_open += R.flip_rate(_host(R.posterior_argmax(po)), ref)
            flip_closed += R.flip_rate(_host(R.posterior_argmax(pc)), ref)
            posts.append((po, pc))
        flip_open /= reps
        flip_closed /= reps
        rows.append((i, cycle, flip_open, flip_closed, recals))
    return {"ref": ref, "rows": rows, "posts": posts, "flip_open": flip_open,
            "flip_closed": flip_closed, "recals": recals, "meta": {"oracle": _host(exact)}}


def ref_hot_swap():
    spec = R.by_name(cs.SWAP_NAME)
    net = R.compile_network(spec, cs.DRIFT_BITS, noise=R.NoiseModel(**cs.SWAP_NOISE),
                            drift_epochs=cs.DRIFT_EPOCHS, devices=1)
    ev = _host(R.sample_evidence(spec, jax.random.PRNGKey(5), cs.SWAP_FRAMES))
    recal = R.recalibrated_network(net, cycle=cs.SWAP_CYCLE)
    twin = R.FrameDriver(net, max_batch=cs.SWAP_BATCH, salt=cs.SWAP_SALT)
    swapped = R.FrameDriver(net, max_batch=cs.SWAP_BATCH, salt=cs.SWAP_SALT)
    t_rids, s_rids = twin.submit(ev), swapped.submit(ev)
    for drv in (twin, swapped):
        drv.step(block=False)
        drv.step(block=False)
    swapped.swap_net(recal)
    out_twin = {r: (_host(p), a) for r, (p, a) in twin.drain().items()}
    out_swapped = {r: (_host(p), a) for r, (p, a) in swapped.drain().items()}
    lost = len(set(s_rids) - set(out_swapped))
    pre = 2 * cs.SWAP_BATCH
    preserved = lost == 0 and swapped.net is recal and all(
        np.array_equal(out_twin[t][0], out_swapped[s][0]) and out_twin[t][1] == out_swapped[s][1]
        for t, s in zip(t_rids[:pre], s_rids[:pre]))
    return {"twin": out_twin, "swapped": out_swapped, "lost": lost, "preserved": preserved}


class _RefRecording(R.DriftMonitor):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.trajectory = []

    def observe_launch(self, confidence, accept_rate, flip=None):
        state = super().observe_launch(confidence, accept_rate, flip)
        self.trajectory.append((confidence, accept_rate, state, self.as_dict()))
        return state


def ref_monitor_run(name, noisy, mode):
    spec = R.by_name(name)
    net = R.compile_network(spec, cs.MONITOR_BITS,
                            noise=R.NoiseModel(**cs.MONITOR_NOISE) if noisy else None)
    mon = _RefRecording(R.DriftPolicy(**cs.MONITOR_POLICY))
    drv = R.FrameDriver(net, max_batch=cs.MONITOR_BATCH, base_key=jax.random.PRNGKey(5),
                        salt=cs.MONITOR_SALT, drift=mon)
    _, out = _ref_drained(drv, cs._evidence(spec, cs.MONITOR_FRAMES, seed=7), mode)
    return {"out": out, "trajectory": mon.trajectory, "launches": drv.launches}


def _hold(port, ref):
    cs.held_equal(port, ref, "port against the reference")
    if "oracle" in ref.get("meta", {}):
        np.testing.assert_allclose(port["meta"]["oracle"], ref["meta"]["oracle"],
                                   rtol=0, atol=ORACLE_ATOL)


@pytest.mark.parametrize("name", ["pedestrian-night", "obstacle-class"])
def test_flip_curves_match_reference(name):
    port = cs.flip_curves(name, "cpu", frames=FRAMES, **FLIP_SIZES)
    _hold(port, ref_flip_curves(name, FRAMES, **FLIP_SIZES))
    assert len(port["meta"]["plans"]) == len(cs.REL_SCALES) + 1    # 256 bits is a decide of its own


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_retry_race_matches_reference(mode):
    port = cs.retry_race("obstacle-detection", "cpu", mode, frames=FRAMES)
    _hold(port, ref_retry_race("obstacle-detection", mode, FRAMES))
    assert port["stats"]["frames"] == FRAMES and port["stats"]["retries"] > 0


@pytest.mark.parametrize("name", ["sensor-degradation", "obstacle-class"])
def test_aging_race_matches_reference(name):
    port = cs.aging_race(name, "cpu", **RACE_SIZES)
    _hold(port, ref_aging_race(name, **RACE_SIZES))
    assert [row[4] for row in port["rows"]] == [1, 1, 2]            # a refit every other launch
    assert len(port["posts"]) == RACE_SIZES["launches"] - 1 + RACE_SIZES["final_repeats"]


def test_hot_swap_matches_reference():
    port = cs.hot_swap("cpu")
    _hold(port, ref_hot_swap())
    assert port["lost"] == 0 and port["preserved"]
    assert sorted(port["swapped"]) == list(range(cs.SWAP_FRAMES))


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_monitor_run_matches_reference(mode):
    port = cs.monitor_run("pedestrian-night", True, mode, "cpu")
    _hold(port, ref_monitor_run("pedestrian-night", True, mode))
    assert port["launches"] == cs.MONITOR_FRAMES // cs.MONITOR_BATCH


@pytest.mark.parametrize("change", ["value", "key", "length"])
def test_held_equal_finds_a_difference(change):
    want = {"a": np.zeros(3, np.float32), "b": [(1, 0.5)], "meta": {"t": 1.0}}
    got = {"a": want["a"].copy(), "b": [(1, 0.5)], "meta": {"t": 2.0}}
    cs.held_equal(got, want)                                       # meta is not held
    if change == "value":
        got["a"][1] = np.nextafter(np.float32(0), np.float32(1))
    elif change == "key":
        got["c"] = 0
    else:
        got["b"].append((2, 0.5))
    with pytest.raises(AssertionError):
        cs.held_equal(got, want)
