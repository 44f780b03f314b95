"""The paper's operators against the JAX reference: superset completion
(``core/cordiv.py``), the inference operator (``core/inference.py``), the
Fig S8 motifs (``core/graph.py``) and the stochastic fusion circuit
(``core/fusion.py``); the exports of ``repro_torch.core``; mirrors of
``tests/core/test_inference_fusion.py`` run through both packages.

Every stream of an ``InferenceTrace`` / ``FusionTrace`` and every motif
stream is bit for bit; ``posterior_ratio``, ``posterior_scan``,
``fused_ratio`` and ``fused_scan`` divide the same integers on both sides and
are exact float32.  The analytic oracles are held within ORACLE_ATOL (float32
products and quotients; equal in practice), ``fused_analytic`` within
fusion_map's atol 2e-6, rtol 1e-5 (log/exp).
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypcompat import given, settings, st  # optional-hypothesis shim (tests/hypcompat.py)

import repro.core as J
from repro.core import cordiv as jcordiv
from repro.core import fusion as jfusion
from repro.core import graph as jgraph
from repro.core import inference as jinference
from repro.core import sne as jsne
import repro_torch.core as T
from repro_torch.core import bitops, cordiv, correlation, fusion, graph, inference, prng, sne

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_BITS = 1 << 14
TOL = 0.03
ORACLE_ATOL = 1e-7
FM_ATOL, FM_RTOL = 2e-6, 1e-5


def _kd(k):
    return np.asarray(k, np.uint32)


def _eq(got, want):
    want = np.asarray(want)
    if want.dtype == np.uint32:
        want = want.view(np.int32)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _close(got, want, atol=ORACLE_ATOL, rtol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=rtol)


def _inference(key_seed, *args, n_bits=N_BITS, marginal=False):
    k = jax.random.PRNGKey(key_seed)
    fn = "bayes_inference_marginal" if marginal else "bayes_inference"
    got = getattr(inference, fn)(_kd(k), *args, n_bits=n_bits, device="cpu")
    want = getattr(jinference, fn)(k, *args, n_bits=n_bits)
    assert list(got.streams) == list(want.streams) and got.n_bits == want.n_bits
    for name in want.streams:
        _eq(got.streams[name], want.streams[name])
    _eq(got.posterior_scan, want.posterior_scan)
    _eq(got.posterior_ratio, want.posterior_ratio)
    _close(got.posterior_analytic, want.posterior_analytic)
    return got


def _fusion(key_seed, p_modal, n_bits=N_BITS, prior=None, impl="fast"):
    k = jax.random.PRNGKey(key_seed)
    got = fusion.bayes_fusion(_kd(k), p_modal, n_bits=n_bits, prior=prior, impl=impl, device="cpu")
    want = jfusion.bayes_fusion(k, np.asarray(p_modal), n_bits=n_bits, prior=prior, impl=impl)
    for name in ("numer", "denom"):
        _eq(got.streams[name], want.streams[name])
    _eq(got.fused_scan, want.fused_scan)
    _eq(got.fused_ratio, want.fused_ratio)
    _close(got.fused_analytic, want.fused_analytic, FM_ATOL, FM_RTOL)
    return got


def test_core_exports_every_reference_name():
    ref = {n for n in dir(J) if not n.startswith("_")}
    port = {n for n in dir(T) if not n.startswith("_")}
    assert ref <= port, sorted(ref - port)


@pytest.mark.parametrize("n_bits", [100, 1000])
@pytest.mark.parametrize("p", [(0.3, 0.8), (0.0, 0.5), (0.6, 0.6), (0.9, 0.2)])
def test_make_superset_bit_exact(n_bits, p):
    k = jax.random.PRNGKey(n_bits)
    numer = jsne.encode_uncorrelated(jax.random.PRNGKey(1), p[0], n_bits)
    got = cordiv.make_superset(_kd(k), torch.from_numpy(np.asarray(numer).view(np.int32)),
                               p[0], p[1], n_bits)
    _eq(got, jcordiv.make_superset(k, numer, p[0], p[1], n_bits))


@pytest.mark.parametrize("n_bits", [100, 128, 1000])
def test_inference_traces_bit_exact(n_bits):
    _inference(n_bits, 0.57, 0.72, 0.6, n_bits=n_bits)
    _inference(n_bits + 1, np.array([0.2, 0.5, 0.9], np.float32), 0.9, np.array([0.1, 0.5, 0.3],
                                                                                 np.float32),
               n_bits=n_bits)
    _inference(n_bits + 2, 0.57, 0.78, 0.72, n_bits=n_bits, marginal=True)
    _inference(n_bits + 3, 0.5, 0.4, 0.0, n_bits=n_bits, marginal=True)       # P(B) = 0


@pytest.mark.parametrize("n_bits", [100, 1000])
def test_motifs_bit_exact(n_bits):
    k = jax.random.PRNGKey(n_bits)
    cpt = np.array([[0.1, 0.6], [0.35, 0.9]], np.float32)
    for g, w in zip(graph.two_parent_one_child(_kd(k), 0.3, 0.7, cpt, n_bits, device="cpu"),
                    jgraph.two_parent_one_child(k, 0.3, 0.7, cpt, n_bits)):
        _eq(g, w)
    args = (0.5, (0.9, 0.2), (0.8, 0.3))
    for g, w in zip(graph.one_parent_two_child(_kd(k), *args, n_bits, device="cpu"),
                    jgraph.one_parent_two_child(k, *args, n_bits)):
        _eq(g, w)
    pa = np.linspace(0.05, 0.95, 7, dtype=np.float32)
    _close(graph.analytic_two_parent(pa, pa[::-1].copy(), cpt, device="cpu"),
           jgraph.analytic_two_parent(pa, pa[::-1].copy(), cpt))
    _close(graph.analytic_one_parent_two_child(pa, (0.9, 0.2), (0.8, 0.3), device="cpu"),
           jgraph.analytic_one_parent_two_child(pa, (0.9, 0.2), (0.8, 0.3)))


@pytest.mark.parametrize("impl", ["fast", "threefry"])
@pytest.mark.parametrize("m,k,n_bits", [(2, 16, 128), (3, 5, 100)])
def test_fusion_traces_bit_exact(impl, m, k, n_bits):
    p = np.random.default_rng(m * k).dirichlet(np.ones(k), size=(6, m)).astype(np.float32)
    prior = np.random.default_rng(k).dirichlet(np.ones(k)).astype(np.float32)
    _fusion(m * k, p, n_bits=n_bits, prior=prior if m == 3 else None, impl=impl)


def test_detection_fusion_bit_exact():
    k = jax.random.PRNGKey(8)
    p = np.random.default_rng(0).uniform(0.02, 0.98, (64, 2)).astype(np.float32)
    _eq(fusion.detection_fusion(_kd(k), p, n_bits=1024, device="cpu"),
        jfusion.detection_fusion(k, p, n_bits=1024))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs there")
    key = prng.PRNGKey(0)
    for call in (lambda: inference.bayes_inference(key, 0.5, 0.5, 0.5),
                 lambda: inference.bayes_inference_marginal(key, 0.5, 0.5, 0.5),
                 lambda: inference.analytic_posterior(0.5, 0.5, 0.5),
                 lambda: graph.two_parent_one_child(key, 0.5, 0.5, [[0.1, 0.2], [0.3, 0.4]]),
                 lambda: graph.one_parent_two_child(key, 0.5, (0.9, 0.2), (0.8, 0.3)),
                 lambda: fusion.bayes_fusion(key, [[0.5, 0.5], [0.6, 0.4]]),
                 lambda: fusion.detection_fusion(key, [0.5, 0.6])):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()


def test_paper_layer_imports_neither_jax_nor_the_reference():
    mods = ("repro_torch.core", "repro_torch.core.sne", "repro_torch.core.logic",
            "repro_torch.core.correlation", "repro_torch.core.inference", "repro_torch.core.graph",
            "repro_torch.core.fusion", "repro_torch.core.latency", "repro_torch.core.device",
            "repro_torch.examples.quickstart", "repro_torch.examples.route_planning",
            "repro_torch.examples.scene_graph", "repro_torch.examples.obstacle_fusion")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print(' '.join(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'repro_torch'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.split())
    assert set(mods) <= loaded
    assert not {m for m in loaded if not m.startswith("repro_torch")}


# --- mirrors of tests/core/test_inference_fusion.py, both packages ------------------


def test_cordiv_scan_equals_ratio_on_subset():
    kd, extra = prng.split(prng.PRNGKey(0))
    d = sne.encode_uncorrelated(kd, 0.7, N_BITS, device="cpu")
    n = d & sne.encode_uncorrelated(extra, 0.6, N_BITS, device="cpu")
    _, est_scan = cordiv.cordiv_scan(n, d, N_BITS)
    est_ratio = cordiv.cordiv_ratio(n, d)
    assert abs(float(est_scan) - float(est_ratio)) < TOL
    assert abs(float(est_ratio) - 0.6) < TOL


def test_make_superset():
    k1, k2 = prng.split(prng.PRNGKey(5))
    n = sne.encode_uncorrelated(k1, 0.3, N_BITS, device="cpu")
    d = cordiv.make_superset(k2, n, 0.3, 0.8, N_BITS)
    assert int(bitops.popcount(n & ~d)) == 0
    assert abs(float(bitops.decode(d, N_BITS)) - 0.8) < TOL


@pytest.mark.parametrize("pa,pba,pbn", [(0.57, 0.72, 0.6), (0.2, 0.9, 0.1), (0.8, 0.5, 0.5),
                                        (0.5, 0.99, 0.01)])
def test_inference_operator_matches_eq1(pa, pba, pbn):
    tr = _inference(int(pa * 100 + pba * 10), pa, pba, pbn)
    expect = float(inference.analytic_posterior(pa, pba, pbn, device="cpu"))
    assert abs(float(tr.posterior_ratio) - expect) < TOL
    assert abs(float(tr.posterior_scan) - expect) < 2 * TOL
    assert int(bitops.popcount(tr.streams["numer"] & ~tr.streams["denom"])) == 0


def test_route_planning_case_paper_band():
    """Fig 3b: P(A)=57%, evidence ~72% -> posterior in the paper's 61-63% band."""
    tr = _inference(2024, 0.57, 0.72, 0.6)
    assert 0.58 < float(tr.posterior_ratio) < 0.66
    assert float(tr.posterior_ratio) > 0.57


def test_inference_marginal_variant():
    tr = _inference(11, 0.57, 0.78, 0.72, marginal=True)
    assert abs(float(tr.posterior_ratio) - 0.57 * 0.78 / 0.72) < TOL


def test_operator_correlation_design():
    """Fig 3c/3d: the SNE streams feeding AND/MUX are mutually uncorrelated."""
    s = _inference(9, 0.57, 0.72, 0.6).streams
    for x, y in [("A", "B|A"), ("A", "B|!A"), ("B|A", "B|!A")]:
        assert abs(float(correlation.pearson(s[x], s[y], N_BITS))) < 0.05
    assert float(correlation.scc(s["numer"], s["denom"], N_BITS)) > 0.9


@given(pa1=st.floats(0.05, 0.95), pa2=st.floats(0.05, 0.95), seed=st.integers(0, 2**31 - 1))
@settings(max_examples=8, deadline=None)
def test_two_parent_property(pa1, pa2, seed):
    cpt = np.array([[0.1, 0.4], [0.6, 0.9]], np.float32)
    k = jax.random.PRNGKey(seed)
    got = graph.two_parent_one_child(_kd(k), pa1, pa2, cpt, n_bits=N_BITS, device="cpu")
    for g, w in zip(got, jgraph.two_parent_one_child(k, pa1, pa2, cpt, n_bits=N_BITS)):
        _eq(g, w)
    _, post_ratio, analytic = got
    assert abs(float(post_ratio) - float(analytic)) < 0.06
    assert 0.0 <= float(post_ratio) <= 1.0


def test_one_parent_two_child():
    _, post_ratio, analytic = graph.one_parent_two_child(prng.PRNGKey(1), 0.5, (0.9, 0.2),
                                                         (0.8, 0.3), n_bits=N_BITS, device="cpu")
    assert abs(float(post_ratio) - float(analytic)) < TOL


def test_fusion_matches_eq5_binary():
    tr = _fusion(3, np.array([[0.8, 0.2], [0.7, 0.3]], np.float32))
    np.testing.assert_allclose(tr.fused_ratio.numpy(), tr.fused_analytic.numpy(), atol=0.04)
    np.testing.assert_allclose(tr.fused_scan.numpy(), tr.fused_analytic.numpy(), atol=0.08)


@given(m=st.integers(2, 4), k=st.integers(2, 5), seed=st.integers(0, 2**31 - 1))
@settings(max_examples=3, deadline=None)
def test_fusion_property(m, k, seed):
    kp, _ = jax.random.split(jax.random.PRNGKey(seed))
    p = np.asarray(jax.nn.softmax(jax.random.normal(kp, (m, k)), axis=-1) * 0.9 + 0.05)
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    tr = _fusion(seed, p)
    assert abs(float(tr.fused_ratio.sum()) - 1.0) < 1e-5
    np.testing.assert_allclose(tr.fused_ratio.numpy(), tr.fused_analytic.numpy(), atol=0.04 * m)


def test_fusion_recovers_missed_target():
    """Fig 4b: one weak + one confident modality -> a confident fused decision."""
    k = jax.random.PRNGKey(8)
    fused = fusion.detection_fusion(_kd(k), [0.55, 0.95], n_bits=N_BITS, device="cpu")
    _eq(fused, jfusion.detection_fusion(k, jnp.array([0.55, 0.95]), n_bits=N_BITS))
    assert float(fused) > 0.9
    analytic = fusion.fuse_analytic(torch.tensor([[0.55, 0.45], [0.95, 0.05]]))[0]
    assert abs(float(fused) - float(analytic)) < 0.05
