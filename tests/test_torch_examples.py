"""The four example flows of ``repro_torch.examples`` against the reference's
scripts (``examples/*.py``), whose calls are made inline here at reduced
sizes: quickstart at 256 bits, route_planning's audit at 1024 bits,
scene_graph at 256 frames of 1024 bits, obstacle_fusion on a 32x32 scene.

Streams, counts, posteriors and decisions are bit for bit; the enumeration
oracle within ORACLE_ATOL (float32 sums in another order), fusion_map and
``fused_analytic`` within atol 2e-6, rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.bayesnet as R
from repro.bayesnet.compile import lower_streams as jlower_streams
from repro.core import (Corr, bayes_fusion, bayes_inference, correlation, cordiv, logic,
                        sne)
from repro.data import detection as jdet
from repro.kernels.bayes_decide.ops import bayes_decide as jbayes_decide
from repro.kernels.fusion_map.ops import fusion_map as jfusion_map
from repro_torch.examples import obstacle_fusion, quickstart, route_planning, scene_graph

torch.set_num_threads(1)

ORACLE_ATOL = 5e-7
FM_ATOL, FM_RTOL = 2e-6, 1e-5
PART = bool(jax.config.jax_threefry_partitionable)
pytestmark = pytest.mark.skipif(not PART, reason="the examples split keys under the "
                                "partitionable layout")


def _eq(got, want):
    want = np.asarray(want)
    if want.dtype == np.uint32:
        want = want.view(np.int32)
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_quickstart_equals_the_reference_script():
    n = 256
    r = quickstart.run("cpu", n_bits=n)
    key = jax.random.PRNGKey(0)
    _eq(r["stream"], sne.encode_uncorrelated(key, quickstart.P, n))
    _eq(r["and_unc"], logic.prob_and(key, 0.8, 0.6, n, Corr.UNCORRELATED)[0])
    _eq(r["and_pos"], logic.prob_and(key, 0.8, 0.6, n, Corr.POSITIVE)[0])
    kd, ke = jax.random.split(key)
    d = sne.encode_uncorrelated(kd, 0.8, n)
    quotient, q = cordiv.cordiv_scan(d & sne.encode_uncorrelated(ke, 0.5, n), d, n)
    _eq(r["quotient"], quotient)
    _eq(r["q"], q)
    tr = bayes_inference(key, p_a=0.57, p_b_given_a=0.72, p_b_given_nota=0.6, n_bits=n)
    for name in tr.streams:
        _eq(r["inference"].streams[name], tr.streams[name])
    _eq(r["inference"].posterior_ratio, tr.posterior_ratio)
    ftr = bayes_fusion(key, jnp.array(quickstart.P_MODAL), n_bits=n)
    _eq(r["fusion"].fused_ratio, ftr.fused_ratio)
    _eq(r["fusion"].fused_scan, ftr.fused_scan)
    np.testing.assert_allclose(r["fusion"].fused_analytic.numpy(), np.asarray(ftr.fused_analytic),
                               atol=FM_ATOL, rtol=FM_RTOL)
    assert r["latency"].meets_paper_claim()


def test_route_planning_equals_the_reference_script():
    r = route_planning.run("cpu", audit_bits=1024)
    spec = R.NetworkSpec(
        name="route-planning",
        nodes=(R.Node("cut_in", (), (route_planning.P_A,)),
               R.Node("lane_state", ("cut_in",),
                      (route_planning.P_B_GIVEN_NOT_A, route_planning.P_B_GIVEN_A))),
        evidence=("lane_state",), queries=("cut_in",))
    net = R.compile_network(spec, n_bits=96)
    theory = float(R.make_posterior_fn(spec)(np.asarray([[1]]))[0][0, 0])
    assert abs(float(r["theory"]) - theory) <= ORACLE_ATOL
    driver = R.FrameDriver(net, max_batch=8, base_key=jax.random.PRNGKey(2024), salt=0)
    driver.submit(np.ones((5, 1), np.int32))
    want = sorted(driver.drain().items())
    assert [t for t, _ in r["frames"]] == [t for t, _ in want] == list(range(5))
    for (_, (post, acc)), (_, (wpost, wacc)) in zip(r["frames"], want):
        _eq(post, wpost)
        assert acc == wacc
    streams = jlower_streams(spec, jax.random.PRNGKey(2024), 1024)
    names = list(spec.topo_order())
    assert r["names"] == names
    for n in names:
        _eq(r["streams"][n][0], streams[n][0])
    _eq(r["rho"], correlation.correlation_matrix({n: streams[n][0] for n in names}, 1024,
                                                 "pearson"))


def test_scene_graph_equals_the_reference_script():
    n_frames, n_bits = 256, 1024
    r = scene_graph.run("cpu", n_frames=n_frames, n_bits=n_bits, motif_bits=n_bits)
    key = jax.random.PRNGKey(0)
    motif = R.NetworkSpec(
        name="fig-s8b",
        nodes=(R.Node("a1", (), (0.30,)), R.Node("a2", (), (0.70,)),
               R.Node("b", ("a1", "a2"), scene_graph.CPT[0] + scene_graph.CPT[1])),
        evidence=("b",), queries=("a1",))
    post, acc = R.compile_network(motif, n_bits=n_bits).run(key, jnp.array([[1]]))
    _eq(r["motif_post"], post)
    _eq(r["motif_acc"], acc)
    spec = R.by_name("pedestrian-night")
    net = R.compile_network(spec, n_bits=n_bits)
    ev = R.sample_evidence(spec, jax.random.PRNGKey(1), n_frames)
    _eq(r["ev"], ev)
    post, acc = net.run(key, ev)
    _eq(r["post"], post)
    _eq(r["acc"], acc)
    sp, _ = R.compile_network(spec, n_bits=n_bits, share_entropy=True).run(key, ev)
    _eq(r["shared_post"], sp)
    exact, _ = R.make_posterior_fn(spec, dac_quantize=True)(ev)
    np.testing.assert_allclose(r["exact"].numpy(), np.asarray(exact), atol=ORACLE_ATOL, rtol=0)
    drv = R.FrameDriver(net, max_batch=512, base_key=jax.random.PRNGKey(2), salt=0)
    drv.submit(np.array(scene_graph.NIGHT_FRAME))
    drv.submit(np.array(scene_graph.DAY_FRAME))
    out = drv.drain()
    for rid in (0, 1):
        _eq(r["streamed"][rid][0], out[rid][0])
        assert r["streamed"][rid][1] == out[rid][1]
    cspec = R.by_name("obstacle-class")
    cnet = R.compile_network(cspec, n_bits=n_bits)
    cev = R.sample_evidence(cspec, jax.random.PRNGKey(3), n_frames)
    cpost, cacc = cnet.run(key, cev)
    _eq(r["class_post"], cpost)
    _eq(r["class_acc"], cacc)
    for g, w in zip(r["decide"], cnet.decide(jax.random.PRNGKey(5),
                                            np.stack([np.array(scene_graph.CLASS_FRAME)]))):
        _eq(g, w)


def test_obstacle_fusion_equals_the_reference_script():
    r = obstacle_fusion.run("cpu", height=32, width=32, tile=512)
    cfg = jdet.SceneConfig(height=32, width=32, night_fraction=1.0)
    gt, p_rgb, p_th, _ = jdet.make_scene(jax.random.PRNGKey(0), cfg)
    assert r["gt_pixels"] == int(gt.sum())
    p_modal = jnp.stack([jnp.stack([p_rgb, 1 - p_rgb], -1).reshape(-1, 2),
                         jnp.stack([p_th, 1 - p_th], -1).reshape(-1, 2)])
    fused = jfusion_map(p_modal)[:, 0]
    np.testing.assert_allclose(r["fused"].numpy(), np.asarray(fused), atol=FM_ATOL, rtol=FM_RTOL)
    for name, p in (("RGB", p_rgb), ("thermal", p_th), ("fused", fused.reshape(gt.shape))):
        np.testing.assert_allclose(r["rates"][name],
                                   [float(v) for v in jdet.detection_metrics(gt, p)],
                                   atol=FM_ATOL, rtol=FM_RTOL)
    dec, cnt = jbayes_decide(jax.random.PRNGKey(1), p_modal[:, :512], 256)
    _eq(r["dec"], dec)
    _eq(r["cnt"], cnt)


def test_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs there")
    for mod in (quickstart, route_planning, scene_graph, obstacle_fusion):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            mod.run()
