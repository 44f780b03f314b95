"""The port's unfused lowering against the JAX reference, on the CPU.

``compile_network(..., device="cpu")`` of the port against the reference's
``compile_network`` on all 7 scenarios: ``fused=False`` (gather, ratio
estimator), ``share_entropy=True``, ``mux_mode='rows'`` on the binary
scenarios, ``estimator='fill'`` on a binary and a k-ary scenario, nominal
noise and ``program=``.  Counts, posteriors (the ``fill`` ones included)
and decisions must be equal bit for bit: every stream is integer work and
every posterior a float32 quotient of exact integers, or of multiples of
``1 / n_bits`` that sum exactly.  Then ``FrameDriver`` over unfused networks
against the reference driver with the same ``(base_key, salt)``, rid for
rid.  Reference networks are compiled once per module and driven at one
batch shape, so each jit compiles once.
"""

import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.bayesnet as R
from repro.bayesnet import compile as rcompile
import repro_torch.bayesnet as T
from repro_torch.bayesnet import compile as tcompile
from repro_torch.core import prng

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = sorted(R.SCENARIOS)
BINARY = [n for n in NAMES if R.by_name(n).max_card() == 2]
N_BITS, B, SALT, BASE = 256, 8, 41, 13

# mode -> compile_network keywords ("noise" / "program" are filled in per package)
MODES = {
    "unfused": dict(fused=False),
    "shared": dict(share_entropy=True),
    "rows": dict(mux_mode="rows"),
    "fill": dict(estimator="fill"),
    "noise": dict(fused=False, noise="nominal"),
    "program": dict(fused=False, program=True),
    "noise_program": dict(fused=False, noise="nominal", program=True),
}
GRID = ([(n, "unfused") for n in NAMES] + [(n, "shared") for n in NAMES]
        + [(n, "rows") for n in BINARY]
        + [("lane-change", "fill"), ("obstacle-class", "fill"),
           ("intersection-cat", "noise"), ("pedestrian-night", "noise"),
           ("sensor-degradation", "program"), ("obstacle-detection", "noise_program")])


def _program(name):
    """Programmed thresholds a few DAC steps below the clean ones, on 3 nodes."""
    spec = T.by_name(name)
    clean = T.perturbed_cdf_rows(spec, None)
    return {n: tuple(tuple(max(0, t - 3) for t in row) for row in clean[n])
            for n in spec.topo_order()[:3]}


def _kwargs(name, mode, pkg):
    kw = dict(MODES[mode])
    if "noise" in kw:
        kw["noise"] = pkg.NoiseModel.nominal()
    if "program" in kw:
        kw["program"] = _program(name)
    return kw


@functools.lru_cache(maxsize=None)
def _rnet(name, mode, n_bits=N_BITS):
    return R.compile_network(R.by_name(name), n_bits=n_bits, **_kwargs(name, mode, R))


def _tnet(name, mode, n_bits=N_BITS):
    return T.compile_network(T.by_name(name), n_bits=n_bits, device="cpu",
                             **_kwargs(name, mode, T))


def _frames(name, n=B, seed=5):
    spec = R.by_name(name)
    r = np.random.default_rng(seed)
    return np.stack([r.integers(0, spec.card(e), n) for e in spec.evidence], 1).astype(np.int32)


@pytest.mark.parametrize("name,mode", GRID, ids=[f"{n}-{m}" for n, m in GRID])
def test_unfused_program_matches_reference(name, mode):
    rnet, tnet = _rnet(name, mode), _tnet(name, mode)
    assert not tnet.fused and tcompile.network_stats(tnet) == rcompile.network_stats(rnet)
    ev = _frames(name)
    for seed in (0, 17):
        rpost, racc = rnet.run(jax.random.PRNGKey(seed), ev)
        tpost, tdec, tacc = tnet.decide(prng.PRNGKey(seed), ev)
        np.testing.assert_array_equal(tpost.numpy(), np.asarray(rpost))
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(racc))
        # the reference's unfused decide is posterior_argmax of its posterior
        np.testing.assert_array_equal(tdec.numpy(), np.asarray(R.posterior_argmax(rpost)))
        assert tpost.dtype == torch.float32 and tacc.dtype == torch.int32


def test_lower_streams_match_reference():
    for name, batch in (("intersection-cat", 3), ("lane-change", None)):
        rs = rcompile.lower_streams(R.by_name(name), jax.random.PRNGKey(4), 128, batch=batch)
        ts = tcompile.lower_streams(T.by_name(name), prng.PRNGKey(4), 128, batch=batch,
                                    device="cpu")
        assert list(ts) == list(rs)
        for node, planes in rs.items():
            assert len(ts[node]) == len(planes)
            for t, r in zip(ts[node], planes):
                np.testing.assert_array_equal(t.numpy().view(np.uint32), np.asarray(r))


def test_unfused_run_reuses_the_tables_built_at_compile(monkeypatch):
    name = "obstacle-detection"
    tnet = _tnet(name, "noise_program")
    assert len(tnet.tables) == T.by_name(name).n_nodes
    ev = _frames(name)
    want = tnet.decide(prng.PRNGKey(2), ev)

    def rebuilt(*args, **kwargs):
        raise AssertionError("run rebuilt what compile_network built")
    monkeypatch.setattr(tcompile, "_node_tables", rebuilt)
    monkeypatch.setattr(tcompile, "perturbed_cdf_rows", rebuilt)
    for got, w in zip(tnet.decide(prng.PRNGKey(2), ev), want):
        assert torch.equal(got, w)


# (keywords, spec) pairs the two packages must refuse with the same message:
# the reference's order of checks decides which message comes first
_REFUSALS = [
    (dict(fused=True, share_entropy=True), "lane-change"),
    (dict(fused=True, estimator="fill"), "lane-change"),
    (dict(fused=True, mux_mode="rows"), "lane-change"),
    (dict(fused=False, devices=2), "lane-change"),
    (dict(share_entropy=True, devices=2), "lane-change"),
    (dict(fused=False, noise="nominal", drift_epochs=2), "lane-change"),
    (dict(mux_mode="rows"), "obstacle-class"),
    (dict(mux_mode="rows", fused=True, estimator="fill"), "obstacle-class"),
    (dict(fused=True, share_entropy=True, devices=2), "lane-change"),
]


@pytest.mark.parametrize("kwargs,name", _REFUSALS)
def test_unfused_refusals_match_reference(kwargs, name):
    msgs = []
    for pkg, extra in ((R, {}), (T, {"device": "cpu"})):
        kw = dict(kwargs, **extra)
        if kw.get("noise"):
            kw["noise"] = pkg.NoiseModel.nominal()
        with pytest.raises(ValueError) as err:
            pkg.compile_network(pkg.by_name(name), n_bits=256, **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_new_modules_import_without_jax():
    code = ("import sys; import repro_torch.bayesnet.analytic, repro_torch.core.logic, "
            "repro_torch.core.cordiv, repro_torch.kernels.node_mux, repro_torch.bayesnet; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))"
            " or m == 'repro']; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# --- FrameDriver over unfused networks ---------------------------------------------


def _drivers(name, mode, retry=None):
    """(reference, port) drivers over the same frames; ``retry`` is RetryPolicy keywords."""
    rkw = dict(salt=SALT, retry=None if retry is None else R.RetryPolicy(**retry))
    tkw = dict(salt=SALT, retry=None if retry is None else T.RetryPolicy(**retry))
    rd = R.FrameDriver(_rnet(name, mode), max_batch=B, base_key=jax.random.PRNGKey(BASE), **rkw)
    td = T.FrameDriver(_tnet(name, mode), max_batch=B, base_key=prng.PRNGKey(BASE), **tkw)
    frames = _frames(name, 21, seed=9)
    rd.submit(frames)
    td.submit(frames)
    return rd, td


def _assert_same(tout, rout):
    assert sorted(tout) == sorted(rout)
    for rid, (post, acc) in rout.items():
        tpost, tacc = tout[rid]
        np.testing.assert_array_equal(tpost, np.asarray(post))
        assert tacc == acc


@pytest.mark.parametrize("name,mode", [("intersection-cat", "unfused"),
                                       ("lane-change", "unfused"),
                                       ("obstacle-class", "shared")])
def test_unfused_driver_sync_and_async_match_reference(name, mode):
    rd, td = _drivers(name, mode)
    rout = rd.drain()
    _assert_same(td.drain(), rout)
    _, td2 = _drivers(name, mode)
    _assert_same(td2.drain_async(), rout)
    assert td2.in_flight == 0 and td.launches == 3


def test_unfused_driver_retry_escalation_matches_reference():
    rd, td = _drivers("lane-change", "unfused",
                      retry=dict(min_confidence=0.95, max_retries=2, escalation=2))
    _assert_same(td.drain(), rd.drain())
    treports = {rid: dataclasses.asdict(r) for rid, r in td.reports.items()}
    assert treports == {rid: dataclasses.asdict(r) for rid, r in rd.reports.items()}
    assert any(r["attempts"] > 1 for r in treports.values())
    assert all(not net.fused for net in td._nets.values())


def test_unfused_driver_swap_net_matches_reference():
    rd, td = _drivers("intersection-cat", "unfused")
    rout = rd.step(block=False)
    tout = td.step(block=False)
    rd.swap_net(_rnet("intersection-cat", "noise"))
    td.swap_net(_tnet("intersection-cat", "noise"))
    rout.update(rd.drain())
    tout.update(td.drain())
    _assert_same(tout, rout)
