"""Probabilistic logic (``core/logic.py``) and the correlation metrics
(``core/correlation.py``) against the JAX reference, and mirrors of
``tests/core/test_logic.py`` and ``tests/core/test_properties_extra.py`` run
through both packages.

Streams, estimates (popcounts over n_bits) and the contingency counts are bit
for bit.  ``pearson`` and ``scc`` keep the reference's order of float32
operations and are held bit for bit; ``expected_*`` (the Table S1 oracles) too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypcompat import given, settings, st  # optional-hypothesis shim (tests/hypcompat.py)

from repro.core import bitops as jbitops
from repro.core import cordiv as jcordiv
from repro.core import correlation as jcorr
from repro.core import logic as jlogic
from repro.core import sne as jsne
from repro.core.fusion import fuse_analytic as jfuse_analytic
from repro_torch.core import bitops, cordiv, correlation, logic, prng, sne
from repro_torch.core.fusion import fuse_analytic

torch.set_num_threads(1)

N_BITS = 1 << 14
TOL = 0.03
PROBS = [(0.2, 0.7), (0.5, 0.5), (0.9, 0.3), (0.05, 0.95)]
MODES = list(logic.Corr)


def _jmode(mode):
    return jlogic.Corr[mode.name]


def _kd(k):
    return np.asarray(k, np.uint32)


def _eq(got, want):
    want = np.asarray(want)
    if want.dtype == np.uint32:
        want = want.view(np.int32)
    np.testing.assert_array_equal(got.numpy(), want)


def _both(gate, key_seed, *args, n_bits=N_BITS, mode=logic.Corr.UNCORRELATED):
    """(port result, reference result) of one gate, streams held bit for bit."""
    k = jax.random.PRNGKey(key_seed)
    got = getattr(logic, gate)(_kd(k), *args, n_bits, mode, device="cpu")
    want = getattr(jlogic, gate)(k, *args, n_bits, _jmode(mode))
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    for g, w in zip(got[2], want[2]):
        _eq(g, w)
    return got, want


@pytest.mark.parametrize("n_bits", [100, 1000])
@pytest.mark.parametrize("mode", MODES)
def test_gates_and_pairs_bit_exact(n_bits, mode):
    for gate in ("prob_and", "prob_or", "prob_xor"):
        _both(gate, n_bits, 0.3, 0.65, n_bits=n_bits, mode=mode)
    _both("prob_mux", n_bits + 1, 0.4, 0.3, 0.65, n_bits=n_bits, mode=mode)
    k = jax.random.PRNGKey(2)
    pa = np.array([0.1, 0.5, 0.9], np.float32)
    for g, w in zip(logic.encode_pair(_kd(k), pa, 0.4, n_bits, mode, device="cpu"),
                    jlogic.encode_pair(k, pa, 0.4, n_bits, _jmode(mode))):
        _eq(g, w)


@pytest.mark.parametrize("mode", MODES)
def test_table_s1_oracles_bit_exact(mode):
    pa = np.linspace(0, 1, 11, dtype=np.float32)
    pb = pa[::-1].copy()
    for name in ("expected_and", "expected_or", "expected_xor"):
        _eq(getattr(logic, name)(pa, pb, mode, device="cpu"),
            getattr(jlogic, name)(pa, pb, _jmode(mode)))
    _eq(logic.expected_mux(0.3, pa, pb, device="cpu"), jlogic.expected_mux(0.3, pa, pb))


@pytest.mark.parametrize("impl", ["fast", "threefry"])
@pytest.mark.parametrize("k", [1, 3, 4, 5, 16])
def test_mux_tree_bit_exact(impl, k):
    key = jax.random.PRNGKey(k)
    p = np.random.default_rng(k).uniform(size=(2, k)).astype(np.float32)
    streams = jsne.encode_uncorrelated(key, p, 100)
    out, k_pad = logic.mux_tree(_kd(key), torch.from_numpy(np.asarray(streams).view(np.int32)),
                                100, impl=impl)
    want, want_pad = jlogic.mux_tree(key, streams, 100, impl=impl)
    _eq(out, want)
    assert k_pad == want_pad == 1 << (k - 1).bit_length()


def test_mux_select_bit_exact():
    k = jax.random.PRNGKey(8)
    sel = jsne.encode_uncorrelated(k, np.array([0.3, 0.6], np.float32), 256)
    leaves = jsne.encode_uncorrelated(jax.random.PRNGKey(9), np.linspace(0.1, 0.9, 4,
                                                                        dtype=np.float32), 256)
    got = logic.mux_select(torch.from_numpy(np.asarray(sel).view(np.int32)),
                           torch.from_numpy(np.asarray(leaves).view(np.int32)))
    _eq(got, jlogic.mux_select(sel, leaves))
    with pytest.raises(ValueError):
        logic.mux_select(torch.from_numpy(np.asarray(sel).view(np.int32)),
                         torch.from_numpy(np.asarray(leaves).view(np.int32))[:3])


@pytest.mark.parametrize("n_bits", [100, 1 << 14])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_correlation_metrics_bit_exact(n_bits, seed):
    k = jax.random.PRNGKey(seed)
    p = np.array([0.0, 0.3, 0.5, 0.9, 1.0], np.float32)
    streams = [jsne.encode_uncorrelated(k, p, n_bits), jsne.encode_correlated(k, p, n_bits),
               jsne.encode_correlated(k, p, n_bits, negate=np.array([0, 1, 0, 1, 0], bool))]
    t = [torch.from_numpy(np.asarray(s).view(np.int32)) for s in streams]
    for i in range(3):
        for j in range(3):
            for g, w in zip(correlation.pair_counts(t[i], t[j], n_bits),
                            jcorr.pair_counts(streams[i], streams[j], n_bits)):
                _eq(g, w)
            _eq(correlation.pearson(t[i], t[j], n_bits), jcorr.pearson(streams[i], streams[j], n_bits))
            _eq(correlation.scc(t[i], t[j], n_bits), jcorr.scc(streams[i], streams[j], n_bits))
    for metric in ("pearson", "scc"):
        _eq(correlation.correlation_matrix(list(t[0]), n_bits, metric),
            jcorr.correlation_matrix(list(streams[0]), n_bits, metric))
        named = {f"s{i}": s for i, s in enumerate(t[1])}
        _eq(correlation.correlation_matrix(named, n_bits, metric),
            jcorr.correlation_matrix({f"s{i}": s for i, s in enumerate(streams[1])}, n_bits, metric))


# --- mirrors of tests/core/test_logic.py, both packages -----------------------------


@pytest.mark.parametrize("pa,pb", PROBS)
@pytest.mark.parametrize("mode", MODES)
def test_and_or_xor_all_modes(pa, pb, mode):
    for i, (gate, expected) in enumerate((("prob_and", logic.expected_and),
                                          ("prob_or", logic.expected_or),
                                          ("prob_xor", logic.expected_xor))):
        (_, est, _), _ = _both(gate, 31 * i + PROBS.index((pa, pb)), pa, pb, mode=mode)
        assert abs(float(est) - float(expected(pa, pb, mode, device="cpu"))) < TOL


@pytest.mark.parametrize("ps,pa,pb", [(0.5, 0.2, 0.8), (0.3, 0.9, 0.1), (0.72, 0.57, 0.4)])
@pytest.mark.parametrize("mode_inputs", MODES)
def test_mux_weighted_addition(ps, pa, pb, mode_inputs):
    (_, est, _), _ = _both("prob_mux", int(ps * 100), ps, pa, pb, mode=mode_inputs)
    assert abs(float(est) - float(logic.expected_mux(ps, pa, pb, device="cpu"))) < TOL


def test_mux_corrupted_by_correlated_select():
    """Fig S6b counter-example: select positively correlated with input b."""
    ka, kc = prng.split(prng.PRNGKey(42))
    both = sne.encode_correlated(kc, [0.5, 0.5], N_BITS, device="cpu")
    a = sne.encode_uncorrelated(ka, 0.1, N_BITS, device="cpu")
    est = float(bitops.decode(bitops.bmux(both[0], a, both[1]), N_BITS))
    assert abs(est - float(logic.expected_mux(0.5, 0.1, 0.5, device="cpu"))) > 0.1


@given(pa=st.floats(0.02, 0.98), pb=st.floats(0.02, 0.98), seed=st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_property_and_uncorrelated(pa, pb, seed):
    (_, est, (a, b)), _ = _both("prob_and", seed, pa, pb)
    assert abs(float(est) - pa * pb) < 0.05
    assert abs(float(bitops.decode(a, N_BITS)) - pa) < 0.05
    assert abs(float(bitops.decode(b, N_BITS)) - pb) < 0.05


def test_correlation_modes_measured():
    """Encoded pairs exhibit the designed Pearson/SCC signs (Fig 3c/3d style)."""
    key = prng.PRNGKey(7)
    a, b = logic.encode_pair(key, 0.6, 0.6, N_BITS, logic.Corr.POSITIVE, device="cpu")
    assert float(correlation.scc(a, b, N_BITS)) > 0.9
    a, b = logic.encode_pair(key, 0.6, 0.6, N_BITS, logic.Corr.NEGATIVE, device="cpu")
    assert float(correlation.scc(a, b, N_BITS)) < -0.9
    a, b = logic.encode_pair(key, 0.6, 0.6, N_BITS, logic.Corr.UNCORRELATED, device="cpu")
    assert abs(float(correlation.pearson(a, b, N_BITS))) < 0.05


def test_mux_tree_mean():
    ps = torch.tensor([0.1, 0.5, 0.9])
    streams = sne.encode_uncorrelated(prng.PRNGKey(3), ps, N_BITS, device="cpu")
    out, k_pad = logic.mux_tree(prng.PRNGKey(4), streams, N_BITS)
    assert k_pad == 4
    assert abs(float(bitops.decode(out, N_BITS)) - float(ps.sum()) / 4) < TOL


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs there")
    key = prng.PRNGKey(0)
    for call in (lambda: logic.prob_and(key, 0.5, 0.5, 64),
                 lambda: logic.expected_and(0.5, 0.5, logic.Corr.POSITIVE),
                 lambda: logic.encode_pair(key, 0.5, 0.5, 64, logic.Corr.NEGATIVE),
                 lambda: logic.prob_mux(key, 0.5, 0.2, 0.7, 64)):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()


# --- mirrors of tests/core/test_properties_extra.py, both packages ------------------

N = 1 << 12


@given(seed=st.integers(0, 2**31 - 1), p=st.floats(0.05, 0.95), q=st.floats(0.05, 0.95))
@settings(max_examples=10, deadline=None)
def test_de_morgan_on_streams(seed, p, q):
    k1, k2 = prng.split(prng.PRNGKey(seed))
    a = sne.encode_uncorrelated(k1, p, N, device="cpu")
    b = sne.encode_uncorrelated(k2, q, N, device="cpu")
    jk1, jk2 = jax.random.split(jax.random.PRNGKey(seed))
    _eq(a, jsne.encode_uncorrelated(jk1, p, N))
    lhs = bitops.bnot(bitops.band(a, b), N)
    rhs = bitops.bor(bitops.bnot(a, N), bitops.bnot(b, N))
    assert torch.equal(lhs, rhs)


@given(seed=st.integers(0, 2**31 - 1), p=st.floats(0.02, 0.98))
@settings(max_examples=10, deadline=None)
def test_xor_with_self_and_complement(seed, p):
    a = sne.encode_uncorrelated(prng.PRNGKey(seed), p, N, device="cpu")
    assert int(bitops.popcount(bitops.bxor(a, a))) == 0
    assert int(bitops.popcount(bitops.bxor(a, bitops.bnot(a, N)))) == N


@given(seed=st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_mux_select_partition(seed):
    ks, ka, kb = prng.split(prng.PRNGKey(seed), 3)
    s = sne.encode_uncorrelated(ks, 0.5, N, device="cpu")
    a = sne.encode_uncorrelated(ka, 0.7, N, device="cpu")
    b = sne.encode_uncorrelated(kb, 0.3, N, device="cpu")
    out = bitops.bmux(s, a, b)
    take_b = bitops.popcount(s & b)
    take_a = bitops.popcount(bitops.bnot(s, N) & a)
    assert int(bitops.popcount(out)) == int(take_a) + int(take_b)
    js, ja, jb = (jsne.encode_uncorrelated(k, p, N)
                  for k, p in zip(jax.random.split(jax.random.PRNGKey(seed), 3), (0.5, 0.7, 0.3)))
    _eq(out, jbitops.bmux(js, ja, jb))


@given(seed=st.integers(0, 2**31 - 1), m=st.integers(2, 4), k=st.integers(2, 6))
@settings(max_examples=10, deadline=None)
def test_fusion_analytic_invariants(seed, m, k):
    p = np.asarray(jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(seed), (m, k)), -1))
    out = fuse_analytic(p)
    np.testing.assert_allclose(out.numpy(), np.asarray(jfuse_analytic(p)), atol=2e-6, rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), fuse_analytic(p[::-1].copy()).numpy(), rtol=1e-5)
    assert abs(float(out.sum()) - 1.0) < 1e-5
    fused_same = fuse_analytic(np.stack([p[0]] * m))
    assert float(fused_same.max()) >= float(p[0].max()) - 1e-6


def test_cordiv_range_bounded():
    zeros = torch.zeros((4,), dtype=torch.int32)
    assert float(cordiv.cordiv_ratio(zeros, zeros)) == 0.0
    _, est_scan = cordiv.cordiv_scan(zeros, zeros, 128)
    assert 0.0 <= float(est_scan) <= 1.0
    assert float(jcordiv.cordiv_ratio(jnp.zeros((4,), jnp.uint32), jnp.zeros((4,), jnp.uint32))) == 0.0
