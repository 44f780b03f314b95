"""The paper-figure layer (``repro_torch.core``) and the examples on the card
against ``device="cpu"`` (``cuda`` marker).

Every test skips where ``torch.cuda.is_available()`` is False.  The file
imports neither JAX nor the reference package, so it runs on the machine
with the card:

    python -m pytest -q -p no:cacheprovider tests/test_torch_cuda_core.py

The CPU side is held against the JAX reference by ``tests/test_torch_core*.py``
and ``tests/test_torch_examples.py``.  Tolerances: the device Threefry,
uniforms, streams, counts and ratios of counts are bit for bit; ``normal``
within NORMAL_ULP ulp (the devices' ``log1p`` and ``sqrt`` round apart); the
OU path within OU_ATOL V; the OU recurrence itself, fed the same noise, bit for
bit (its fused multiply-adds are taken in float64 on both devices).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (bitops, correlation, cordiv, device, fusion, graph, inference,
                              logic, prng, rng, sne)
from repro_torch.data import detection
from repro_torch.examples import obstacle_fusion, quickstart, route_planning, scene_graph

torch.set_num_threads(1)

NORMAL_ULP = 4
OU_ATOL = 1e-5
KEY = prng.PRNGKey(20)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _ulp(a, b):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _same(a, b):
    assert a.device.type == "cuda"
    assert torch.equal(a.cpu(), b), float((a.cpu().double() - b.double()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("shape", [(7,), (3, 1001), (2, 2, 33)])
def test_device_threefry_equals_host_cipher(cuda_device, partitionable, shape):
    want = prng.random_bits(KEY, shape, partitionable=partitionable).astype(np.int64)
    got = prng.device_bits(KEY, shape, device=cuda_device, partitionable=partitionable)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    u = prng.device_uniform(KEY, shape, device=cuda_device, partitionable=partitionable)
    np.testing.assert_array_equal(u.cpu().numpy().view(np.uint32),
                                  prng.uniform(KEY, shape, partitionable=partitionable)
                                  .view(np.uint32))


@pytest.mark.cuda
def test_device_threefry_batched_keys(cuda_device):
    keys = prng.split(KEY, 5)
    got = prng.device_bits(keys, (300,), device=cuda_device).cpu().numpy()
    for i in range(5):
        np.testing.assert_array_equal(got[i], prng.random_bits(keys[i], (300,)).astype(np.int64))


@pytest.mark.cuda
def test_normal_and_erf_inv_card_against_cpu(cuda_device):
    got = prng.normal(KEY, (1 << 18,), device=cuda_device)
    want = prng.normal(KEY, (1 << 18,), device="cpu")
    assert _ulp(got, want).max() <= NORMAL_ULP
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, 1 << 16).astype(np.float32))
    x[:3] = torch.tensor([1.0, -1.0, 0.0])
    got, want = prng.erf_inv(x.to(cuda_device)), prng.erf_inv(x)
    assert torch.equal(got[:3].cpu(), want[:3])
    assert _ulp(got[3:], want[3:]).max() <= NORMAL_ULP


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["fast", "threefry"])
@pytest.mark.parametrize("n_bits", [100, 128, 1000])
def test_encoders_bit_for_bit(cuda_device, impl, n_bits):
    p = np.random.default_rng(n_bits).uniform(size=(3, 5)).astype(np.float32)
    p[0, :3] = [0.0, 1.0, 257 / 512]
    neg = np.zeros((3, 5), bool)
    neg[:, 1::2] = True
    for fn, kw in ((sne.encode_uncorrelated, {}), (sne.encode_correlated, {"negate": neg})):
        got = fn(KEY, p, n_bits, impl=impl, device=cuda_device, **kw)
        _same(got, fn(KEY, p, n_bits, impl=impl, device="cpu", **kw))
    _same(rng.fair_bits(KEY, (4,), n_bits, impl=impl, device=cuda_device),
          rng.fair_bits(KEY, (4,), n_bits, impl=impl))
    _same(rng.encode_packed_categorical(KEY, (200, 90, 7), n_bits, batch=3, impl=impl,
                                        device=cuda_device),
          rng.encode_packed_categorical(KEY, (200, 90, 7), n_bits, batch=3, impl=impl))
    streams = sne.encode_uncorrelated(KEY, p, n_bits, device="cpu")
    out, k_pad = logic.mux_tree(KEY, streams.to(cuda_device), n_bits, impl=impl)
    want, want_pad = logic.mux_tree(KEY, streams, n_bits, impl=impl)
    _same(out, want)
    assert k_pad == want_pad == 8
    _same(sne.encode_float_reference(KEY, p, n_bits, device=cuda_device),
          sne.encode_float_reference(KEY, p, n_bits, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(logic.Corr))
def test_gates_and_correlation_bit_for_bit(cuda_device, mode):
    for gate in (logic.prob_and, logic.prob_or, logic.prob_xor):
        got, want = (gate(KEY, 0.3, 0.65, 1000, mode, device=d) for d in (cuda_device, "cpu"))
        _same(got[0], want[0])
        _same(got[1], want[1])
    got, want = (logic.prob_mux(KEY, 0.4, 0.3, 0.65, 1000, mode, device=d)
                 for d in (cuda_device, "cpu"))
    _same(got[0], want[0])
    a, b = logic.encode_pair(KEY, 0.6, 0.35, 1 << 14, mode, device=cuda_device)
    wa, wb = logic.encode_pair(KEY, 0.6, 0.35, 1 << 14, mode, device="cpu")
    for fn in (correlation.pearson, correlation.scc):
        _same(fn(a, b, 1 << 14), fn(wa, wb, 1 << 14))
    for x, y in zip(correlation.pair_counts(a, b, 1 << 14), correlation.pair_counts(wa, wb, 1 << 14)):
        _same(x, y)


@pytest.mark.cuda
def test_operators_bit_for_bit(cuda_device):
    got = inference.bayes_inference(KEY, [0.57, 0.2], [0.72, 0.9], [0.6, 0.1], 1000,
                                    device=cuda_device)
    want = inference.bayes_inference(KEY, [0.57, 0.2], [0.72, 0.9], [0.6, 0.1], 1000,
                                     device="cpu")
    for name in want.streams:
        _same(got.streams[name], want.streams[name])
    _same(got.posterior_scan, want.posterior_scan)
    _same(got.posterior_ratio, want.posterior_ratio)
    got = inference.bayes_inference_marginal(KEY, 0.57, 0.78, 0.72, 1000, device=cuda_device)
    want = inference.bayes_inference_marginal(KEY, 0.57, 0.78, 0.72, 1000, device="cpu")
    _same(got.streams["denom"], want.streams["denom"])
    _same(got.posterior_ratio, want.posterior_ratio)
    cpt = [[0.1, 0.6], [0.35, 0.9]]
    for g, w in zip(graph.two_parent_one_child(KEY, 0.3, 0.7, cpt, 1000, device=cuda_device)[:2],
                    graph.two_parent_one_child(KEY, 0.3, 0.7, cpt, 1000, device="cpu")[:2]):
        _same(g, w)
    for g, w in zip(graph.one_parent_two_child(KEY, 0.5, (0.9, 0.2), (0.8, 0.3), 1000,
                                               device=cuda_device)[:2],
                    graph.one_parent_two_child(KEY, 0.5, (0.9, 0.2), (0.8, 0.3), 1000,
                                               device="cpu")[:2]):
        _same(g, w)
    p = np.random.default_rng(1).dirichlet(np.ones(5), size=(7, 3)).astype(np.float32)
    for impl in ("fast", "threefry"):
        got = fusion.bayes_fusion(KEY, p, 128, impl=impl, device=cuda_device)
        want = fusion.bayes_fusion(KEY, p, 128, impl=impl, device="cpu")
        for name in ("numer", "denom"):
            _same(got.streams[name], want.streams[name])
        _same(got.fused_scan, want.fused_scan)
        _same(got.fused_ratio, want.fused_ratio)
    numer = sne.encode_uncorrelated(KEY, 0.3, 1000, device="cpu")
    _same(cordiv.make_superset(KEY, numer.to(cuda_device), 0.3, 0.8, 1000),
          cordiv.make_superset(KEY, numer, 0.3, 0.8, 1000))
    _same(fusion.detection_fusion(KEY, [[0.55, 0.95], [0.3, 0.6]], 256, device=cuda_device),
          fusion.detection_fusion(KEY, [[0.55, 0.95], [0.3, 0.6]], 256, device="cpu"))


@pytest.mark.cuda
def test_ou_scan_bit_for_bit_and_paths_within_tolerance(cuda_device):
    params = device.DEFAULT_PARAMS
    eps = prng.normal(KEY, (2000, 6), device="cpu")
    mu = device.sample_devices(KEY, 6, device="cpu")
    args = (mu, mu, np.float32(params.ou_theta), np.float32(params.ou_sigma_w))
    _same(device.ou_scan(eps.to(cuda_device), *args), device.ou_scan(eps, *args))
    got = device.sample_ou_path(KEY, 5000, device=cuda_device)
    want = device.sample_ou_path(KEY, 5000, device="cpu")
    assert float((got.cpu() - want).abs().max()) <= OU_ATOL
    assert torch.allclose(device.sample_devices(KEY, 500, device=cuda_device).cpu(),
                          device.sample_devices(KEY, 500, device="cpu"), rtol=0, atol=1e-6)
    for g, w in zip(device.endurance_trace(KEY, 4096, device=cuda_device),
                    device.endurance_trace(KEY, 4096, device="cpu")):
        assert torch.allclose(g.cpu(), w, rtol=1e-5, atol=0)
    bits = device.switching_event(KEY, 2.08, 3000, device=cuda_device)
    assert bits.dtype == torch.uint8 and abs(float(bits.float().mean()) - 0.5) < 0.05


@pytest.mark.cuda
def test_encode_via_device_margin_rule(cuda_device):
    p = np.random.default_rng(2).uniform(0.02, 0.98, 64).astype(np.float32)
    n_bits = 512
    got = sne.encode_via_device(KEY, p, n_bits, device=cuda_device).cpu()
    want = sne.encode_via_device(KEY, p, n_bits, device="cpu")
    assert tuple(got.shape) == (64, n_bits // 32)
    parts = [[t.cpu() for t in sne.device_levels(KEY, p, n_bits, device=d)]
             for d in (cuda_device, "cpu")]
    clear = torch.ones((64, n_bits), dtype=torch.bool)
    for v_in, vth in parts:
        clear &= (v_in[:, None] - vth).abs() > 1e-5
    a, b = (bitops.unpack_bits(w, n_bits).to(torch.bool) for w in (got, want))
    assert not bool((a != b)[clear].any())
    assert int((bitops.popcount(got) - bitops.popcount(want)).abs().max()) <= 2


@pytest.mark.cuda
def test_transfer_curves_and_analytic_oracles(cuda_device):
    v = np.linspace(0.2, 3.5, 23).astype(np.float32)
    for fn in (sne.p_from_vin, sne.p_from_vref):
        assert torch.allclose(fn(v, device=cuda_device).cpu(), fn(v, device="cpu"), atol=1e-6)
    p = np.linspace(0.01, 0.99, 23).astype(np.float32)
    for fn in (sne.vin_from_p, sne.vref_from_p):
        assert torch.allclose(fn(p, device=cuda_device).cpu(), fn(p, device="cpu"), atol=1e-6)
    q = torch.from_numpy(p)
    assert _ulp(sne.ndtri(q.to(cuda_device)), sne.ndtri(q)).max() <= NORMAL_ULP
    for mode in logic.Corr:
        for fn in (logic.expected_and, logic.expected_or, logic.expected_xor):
            _same(fn(0.3, 0.8, mode, device=cuda_device), fn(0.3, 0.8, mode, device="cpu"))
    _same(inference.analytic_posterior(0.57, 0.72, 0.6, device=cuda_device),
          inference.analytic_posterior(0.57, 0.72, 0.6, device="cpu"))


@pytest.mark.cuda
def test_scene_and_evidence_bit_for_bit(cuda_device):
    import repro_torch.bayesnet as T

    cfg = detection.SceneConfig(height=48, width=40, night_fraction=0.5)
    got, want = (detection.make_scene(KEY, cfg, device=d) for d in (cuda_device, "cpu"))
    for g, w in zip(got[:3], want[:3]):
        _same(g, w)
    assert got[3] == want[3]
    spec = T.by_name("obstacle-class")
    _same(T.sample_evidence(spec, KEY, 3000, device=cuda_device),
          T.sample_evidence(spec, KEY, 3000, device="cpu"))


@pytest.mark.cuda
def test_examples_card_against_cpu(cuda_device):
    got, want = (quickstart.run(d, n_bits=256) for d in (cuda_device, "cpu"))
    for name in ("stream", "and_unc", "and_pos", "quotient"):
        _same(got[name], want[name])
    _same(got["fusion"].fused_ratio, want["fusion"].fused_ratio)
    got, want = (route_planning.run(d, audit_bits=1024) for d in (cuda_device, "cpu"))
    assert [(r, p.tolist(), a) for r, (p, a) in got["frames"]] == \
        [(r, p.tolist(), a) for r, (p, a) in want["frames"]]
    _same(got["rho"], want["rho"])
    got, want = (scene_graph.run(d, n_frames=256, n_bits=1024, motif_bits=1024)
                 for d in (cuda_device, "cpu"))
    for name in ("motif_post", "post", "acc", "shared_post", "class_post"):
        _same(got[name], want[name])
    assert torch.allclose(got["exact"].cpu(), want["exact"], atol=5e-7, rtol=0)
    got, want = (obstacle_fusion.run(d, height=32, width=32, tile=512) for d in (cuda_device, "cpu"))
    _same(got["dec"], want["dec"])
    _same(got["cnt"], want["cnt"])
