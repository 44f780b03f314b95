"""The device simulator (``core/device.py``) and the SNEs (``core/sne.py``)
against the JAX reference, and mirrors of ``tests/core/test_device_sne.py``
and ``tests/core/test_device_calibration.py`` run through both packages.

Tolerances:

* the OU recurrence fed the reference's own noise: bit for bit (the reference
  contracts its step into two FMAs; the port takes them in float64);
* draws through ``normal`` (the OU path, device means, endurance trace): the
  noise differs by a few ulp, so OU paths within OU_ATOL V, device means
  within 1e-6 V, resistances within rtol 1e-5;
* ``fit_ou`` of one path: bit for bit (the same float64 fit on the host);
* transfer curves: atol CURVE_ATOL (sigmoid / log);
* ``ndtri``: within NDTRI_ULP ulp; ``encode_via_device``: bits equal wherever
  ``|V_in - V_th|`` exceeds VIA_MARGIN V on both sides, popcounts within
  VIA_COUNT per stream;
* every packed stream of the counter and Threefry encoders: bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitops as jbitops
from repro.core import device as jdevice
from repro.core import latency as jlatency
from repro.core import sne as jsne
from repro_torch.core import bitops, device, latency, prng, sne

torch.set_num_threads(1)

OU_ATOL = 1e-5
CURVE_ATOL = 1e-6
NDTRI_ULP = 8
VIA_MARGIN = 1e-5
VIA_COUNT = 2
PART = bool(jax.config.jax_threefry_partitionable)
P = device.DEFAULT_PARAMS


def _kd(k):
    return np.asarray(k, np.uint32)


def _words(x):
    return np.asarray(x).view(np.int32)


# --- parity with the reference ------------------------------------------------------


@pytest.mark.parametrize("shape", [(), (7,), (2, 3)])
def test_ou_scan_with_the_references_noise_is_bit_exact(shape):
    k = jax.random.PRNGKey(4)
    mu = np.asarray(jdevice.sample_devices(jax.random.PRNGKey(2), int(np.prod(shape)))
                    ).reshape(shape) if shape else np.float32(P.vth_mu)
    x0 = None if shape != (7,) else mu + np.float32(0.3)
    want = np.asarray(jdevice.sample_ou_path(k, 3000, P, mu=mu, x0=x0))
    eps = torch.from_numpy(np.array(jax.random.normal(k, (3000,) + shape)))
    got = device.ou_scan(eps, torch.tensor(mu), torch.tensor(mu if x0 is None else x0),
                         np.float32(P.ou_theta), np.float32(P.ou_sigma_w))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_ou_path_devices_and_endurance_within_tolerance(seed):
    k = jax.random.PRNGKey(seed)
    mu = np.array([1.9, 2.08, 2.3], np.float32)
    for kw in ({}, {"mu": mu}):
        want = np.asarray(jdevice.sample_ou_path(k, 20000, P, **kw))
        got = device.sample_ou_path(_kd(k), 20000, P, device="cpu", **kw)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        assert float(np.abs(got.numpy() - want).max()) <= OU_ATOL
        if got.dim() == 1:
            assert device.fit_ou(got) == jdevice.fit_ou(got.numpy())
    np.testing.assert_allclose(device.sample_devices(_kd(k), 1000, device="cpu").numpy(),
                               np.asarray(jdevice.sample_devices(k, 1000)), atol=1e-6, rtol=0)
    for g, w in zip(device.endurance_trace(_kd(k), 5000, device="cpu"),
                    jdevice.endurance_trace(k, 5000)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=0)
    bits = device.switching_event(_kd(k), 2.08, 4000, device="cpu")
    want = np.asarray(jdevice.switching_event(k, 2.08, 4000))
    assert bits.dtype == torch.uint8 and bits.shape == want.shape
    path = np.asarray(jdevice.sample_ou_path(k, 4000))
    near = np.abs(path - np.float32(2.08)) <= OU_ATOL        # a draw's ulp may flip these
    np.testing.assert_array_equal(bits.numpy()[~near], want[~near])


def test_fit_ou_equals_reference_on_any_path():
    rng_ = np.random.default_rng(0)
    for path in (rng_.normal(2.0, 0.3, 5000), np.cumsum(rng_.normal(0, 1e-3, 5000)) + 2.0):
        assert device.fit_ou(path) == jdevice.fit_ou(path)
        assert device.fit_ou(torch.from_numpy(path)) == jdevice.fit_ou(path)


def test_transfer_curves_within_tolerance():
    v = np.linspace(0.2, 3.6, 35).astype(np.float32)
    p = np.concatenate([[0.0, 1e-7, 1.0], np.linspace(0.001, 0.999, 40)]).astype(np.float32)
    for name, x in (("p_from_vin", v), ("p_from_vref", v), ("vin_from_p", p),
                    ("vref_from_p", p)):
        want = np.asarray(getattr(jsne, name)(x))
        got = getattr(sne, name)(x, device="cpu").numpy()
        np.testing.assert_allclose(got, want, atol=CURVE_ATOL, rtol=0, err_msg=name)


def test_ndtri_within_ulp_of_norm_ppf():
    from jax.scipy.stats import norm

    q = np.random.default_rng(1).uniform(0, 1, 1 << 16).astype(np.float32)
    q[:6] = [0.0, 1.0, 1e-6, 1 - 1e-6, np.exp(-2.0), 0.5]
    q = np.concatenate([q, np.float32(10.0) ** -np.arange(1, 30, dtype=np.float32)])
    want = np.asarray(norm.ppf(q))
    got = sne.ndtri(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got[:2], want[:2])                  # -inf, +inf
    d = np.abs(got[2:].view(np.int32).astype(np.int64) - want[2:].view(np.int32).astype(np.int64))
    assert d.max() <= NDTRI_ULP


@pytest.mark.parametrize("impl", ["fast", "threefry"])
@pytest.mark.parametrize("n_bits", [100, 128, 1000])
def test_encoders_bit_exact(impl, n_bits):
    k = jax.random.PRNGKey(n_bits + 1)
    p = np.random.default_rng(n_bits).uniform(size=(2, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        sne.encode_uncorrelated(_kd(k), p, n_bits, impl=impl, device="cpu").numpy(),
        _words(jsne.encode_uncorrelated(k, p, n_bits, impl=impl)))
    neg = np.zeros((2, 5), bool)
    neg[:, ::2] = True
    np.testing.assert_array_equal(
        sne.encode_correlated(_kd(k), p, n_bits, negate=neg, impl=impl, device="cpu").numpy(),
        _words(jsne.encode_correlated(k, p, n_bits, negate=neg, impl=impl)))
    np.testing.assert_array_equal(
        sne.encode_uncorrelated(_kd(k), 0.72, n_bits, impl=impl, device="cpu").numpy(),
        _words(jsne.encode_uncorrelated(k, 0.72, n_bits, impl=impl)))


@pytest.mark.parametrize("n_bits", [100, 1000])
def test_float_reference_encoder_bit_exact(n_bits):
    k = jax.random.PRNGKey(3)
    p = np.array([[0.1, 0.5], [0.72, 0.99]], np.float32)
    np.testing.assert_array_equal(
        sne.encode_float_reference(_kd(k), p, n_bits, device="cpu").numpy(),
        _words(jsne.encode_float_reference(k, p, n_bits)))


@pytest.mark.parametrize("seed", [4, 5])
def test_encode_via_device_margin_rule(seed):
    """Bits equal wherever both packages put |V_in - V_th| above the margin;
    the reference's V_th comes from its own path, the port's from its own."""
    k = jax.random.PRNGKey(seed)
    n_bits, n = 512, 24
    p = np.random.default_rng(seed).uniform(0.02, 0.98, (4, 6)).astype(np.float32)
    want = np.asarray(jsne.encode_via_device(k, p, n_bits))
    got = sne.encode_via_device(_kd(k), p, n_bits, device="cpu")
    assert tuple(got.shape) == want.shape == (4, 6, n_bits // 32)
    # each side's V_in and V_th per stream
    from jax.scipy.stats import norm

    flat = p.reshape(-1)
    keys = jax.random.split(k, n)
    j_vin = P.vth_mu + P.vth_sigma * np.asarray(norm.ppf(np.clip(flat, 1e-6, 1 - 1e-6)))
    j_vth = np.stack([np.asarray(jdevice.sample_ou_path(kk, n_bits, P)) for kk in keys])
    t_vin, t_vth = (t.numpy() for t in sne.device_levels(_kd(k), p, n_bits, device="cpu"))
    clear = (np.abs(j_vin[:, None] - j_vth) > VIA_MARGIN) & (np.abs(t_vin[:, None] - t_vth) > VIA_MARGIN)
    a = bitops.unpack_bits(got.reshape(n, -1), n_bits).numpy().astype(bool)
    b = np.asarray(jbitops.unpack_bits(jnp.asarray(want.reshape(n, -1)), n_bits)).astype(bool)
    assert not (a != b)[clear].any()
    diff = np.abs(bitops.popcount(got).numpy() - np.asarray(jbitops.popcount(jnp.asarray(want))))
    assert diff.max() <= VIA_COUNT


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs there")
    key = prng.PRNGKey(0)
    for call in (lambda: prng.normal(key, (4,)), lambda: prng.device_bits(key, (4,)),
                 lambda: device.sample_ou_path(key, 10), lambda: device.sample_devices(key, 4),
                 lambda: device.endurance_trace(key, 4), lambda: device.switching_event(key, 2.0, 4),
                 lambda: sne.encode_uncorrelated(key, 0.5, 64), lambda: sne.p_from_vin(2.0),
                 lambda: sne.encode_via_device(key, 0.5, 64)):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()


# --- mirrors of tests/core/test_device_sne.py, both packages ------------------------


def test_ou_stationary_stats():
    for path in (np.asarray(jdevice.sample_ou_path(jax.random.PRNGKey(0), 20000, P)),
                 device.sample_ou_path(prng.PRNGKey(0), 20000, P, device="cpu").numpy()):
        x = path[1000:]
        assert abs(x.mean() - P.vth_mu) < 0.02
        assert abs(x.std() - P.vth_sigma) < 0.03


def test_ou_fit_recovers_params():
    for path in (np.asarray(jdevice.sample_ou_path(jax.random.PRNGKey(1), 50000, P)),
                 device.sample_ou_path(prng.PRNGKey(1), 50000, P, device="cpu")):
        theta, mu, sigma_w = device.fit_ou(path)
        assert abs(theta - P.ou_theta) < 0.05
        assert abs(mu - P.vth_mu) < 0.02
        assert abs(sigma_w - P.ou_sigma_w) < 0.02


def test_device_to_device_cv():
    for mus in (np.asarray(jdevice.sample_devices(jax.random.PRNGKey(2), 2000)),
                device.sample_devices(prng.PRNGKey(2), 2000, device="cpu").numpy()):
        assert abs(mus.std() / mus.mean() - P.d2d_cv) < 0.015


def test_endurance_states_separated():
    for hrs, lrs in (jdevice.endurance_trace(jax.random.PRNGKey(3), 5000),
                     device.endurance_trace(prng.PRNGKey(3), 5000, device="cpu")):
        assert float(np.min(np.asarray(hrs)) / np.max(np.asarray(lrs))) > 1e3


def test_sigmoid_curves_and_inverses():
    v = np.linspace(1.0, 3.5, 11).astype(np.float32)
    p = sne.p_from_vin(v, device="cpu")
    np.testing.assert_allclose(sne.vin_from_p(p, device="cpu").numpy(), v, atol=1e-3)
    assert abs(float(sne.p_from_vin(2.24, device="cpu")) - 0.5) < 1e-6
    vr = np.linspace(0.2, 1.0, 9).astype(np.float32)
    pc = sne.p_from_vref(vr, device="cpu")
    np.testing.assert_allclose(sne.vref_from_p(pc, device="cpu").numpy(), vr, atol=1e-3)
    assert abs(float(sne.p_from_vref(0.57, device="cpu")) - 0.5) < 1e-6
    assert bool(torch.all(torch.diff(p) > 0)) and bool(torch.all(torch.diff(pc) < 0))


@pytest.mark.parametrize("p", [0.1, 0.5, 0.72, 0.9])
def test_encoders_hit_target_probability(p):
    n = 1 << 14
    words = sne.encode_uncorrelated(prng.PRNGKey(1), p, n, device="cpu")
    np.testing.assert_array_equal(words.numpy(),
                                  _words(jsne.encode_uncorrelated(jax.random.PRNGKey(1), p, n)))
    assert abs(float(bitops.decode(words, n)) - p) < 0.02


@pytest.mark.parametrize("p", [0.3, 0.6])
def test_device_driven_encoder_statistically_equivalent(p):
    n = 1 << 13
    for words in (jsne.encode_via_device(jax.random.PRNGKey(4), p, n),
                  sne.encode_via_device(prng.PRNGKey(4), p, n, device="cpu")):
        est = float(np.asarray(jbitops.popcount(jnp.asarray(np.asarray(words).view(np.uint32))))) / n
        assert abs(est - p) < 0.08


def test_switching_event_probability():
    bits = device.switching_event(prng.PRNGKey(5), 2.08, 20000, device="cpu")
    assert abs(float(bits.to(torch.float32).mean()) - 0.5) < 0.05


def test_latency_model_reproduces_paper_claim():
    rep = latency.memristor_latency(n_bits=100)
    assert dataclasses.asdict(rep) == dataclasses.asdict(jlatency.memristor_latency(n_bits=100))
    assert rep.meets_paper_claim()
    assert rep.frame_latency_s == pytest.approx(0.4e-3, rel=1e-6)
    assert rep.fps == pytest.approx(2500.0, rel=1e-6)
    for name in ("HUMAN_REACTION_S", "ADAS_FPS", "CAMERA_FPS", "EDGE_NET_FPS"):
        assert getattr(latency, name) == getattr(jlatency, name)
    # the throughput model is the reference's formula at a rate the caller gives
    rate = 197e12 / 2 / 16
    for n in (100, 128, 4096):
        assert latency.throughput_model(rate, n) == pytest.approx(jlatency.tpu_throughput_model(n))
    with pytest.raises(TypeError):
        latency.throughput_model()                                # no default rate


# --- mirrors of tests/core/test_device_calibration.py, both packages -----------------


def test_reads_per_bit_and_read_cv_formulas():
    for pkg in (jdevice, device):
        p = pkg.DEFAULT_PARAMS
        assert p.reads_per_bit == pytest.approx(80.0)
        assert p.read_cv == pytest.approx((p.vth_sigma / p.vth_mu) / np.sqrt(p.reads_per_bit))
        fast = dataclasses.replace(p, t_bit=p.t_switch)
        assert fast.read_cv == pytest.approx(p.vth_sigma / p.vth_mu)
    assert dataclasses.asdict(device.DEFAULT_PARAMS) == dataclasses.asdict(jdevice.DEFAULT_PARAMS)


def test_sample_devices_custom_params():
    custom = dataclasses.replace(P, vth_mu=1.5, d2d_cv=0.2)
    jcustom = jdevice.MemristorParams(**dataclasses.asdict(custom))
    want = np.asarray(jdevice.sample_devices(jax.random.PRNGKey(0), 4000, jcustom))
    got = device.sample_devices(prng.PRNGKey(0), 4000, custom, device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert abs(got.mean() - 1.5) < 0.02 and abs(got.std() / got.mean() - 0.2) < 0.02


def test_fit_ou_custom_theta_roundtrip():
    custom = dataclasses.replace(P, ou_theta=0.6)
    path = device.sample_ou_path(prng.PRNGKey(1), 50000, custom, device="cpu")
    theta, mu, sigma_w = device.fit_ou(path)
    assert abs(theta - 0.6) < 0.05 and abs(mu - custom.vth_mu) < 0.02
    assert abs(sigma_w - custom.ou_sigma_w) < 0.02


def test_endurance_trace_shapes_and_ratio():
    custom = dataclasses.replace(P, switching_ratio=1e4)
    hrs, lrs = device.endurance_trace(prng.PRNGKey(2), 512, custom, device="cpu")
    assert hrs.shape == lrs.shape == (512,)
    assert bool(torch.all(lrs > 0))
    assert 3e3 < float(hrs.mean() / lrs.mean()) < 3e4


def test_switching_event_saturates():
    ones = device.switching_event(prng.PRNGKey(3), 10.0, 256, device="cpu")
    zeros = device.switching_event(prng.PRNGKey(3), 0.0, 256, device="cpu")
    assert ones.dtype == torch.uint8 and tuple(ones.shape) == (256,)
    assert bool(ones.all()) and not bool(zeros.any())


# --- the OU step's two FMAs on operands that sit on a float32 midpoint ---------------


def _f32_bits(v):
    return int(np.float32(v).view(np.int32))


def _fma_f32(a, b, c):
    """fma(a, b, c) of float32 operands, correctly rounded to float32 (exact
    rational arithmetic, ties to even)."""
    from fractions import Fraction

    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    lo = np.float32(float(exact))                     # within one float32 ulp of it
    cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
    best = min(abs(Fraction(float(v)) - exact) for v in cands)
    near = [v for v in cands if abs(Fraction(float(v)) - exact) == best]
    return near[0] if len(near) == 1 else [v for v in near if not _f32_bits(v) & 1][0]


def _fma_twice_rounded(a, b, c):
    """The old emulation: the float64 add rounded to nearest, then to float32."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _mantissa_pair():
    """Two 24-bit mantissas whose product is 2**47 + d, 0 < d < 2**17: the
    product's bit 47 is followed by 29 zeros, then d."""
    for m_a in range(2**23 + 1, 2**24):
        m_b = -(-2**47 // m_a)
        if 2**23 <= m_b < 2**24 and 0 < m_a * m_b - 2**47 < 2**17:
            return m_a, m_b
    raise AssertionError("no mantissa pair found")


def test_ou_fma1_midpoint_operands_are_bit_exact():
    """fma(theta, mu - x, x) exactly half a float32 ulp below x = 1.5, plus
    less than half a float64 ulp: the old emulation's float64 add lands on the
    midpoint and ties to 1.5; the FMA, and the reference's compiled scan,
    round down."""
    m_t, m_d = _mantissa_pair()
    theta = np.float32(m_t * 2.0**-47)                # 2**-24 <= theta < 2**-23
    d = -np.float32(m_d * 2.0**-24)                   # -1 < d <= -0.5
    cases, x0, mu = [], [], []
    for j in range(4):                                # several streams, one theta
        x = np.float32(1.5 + j * 2.0**-22)            # even mantissas, exponent 0
        x0.append(x)
        mu.append(np.float32(x + d))
        assert np.float32(mu[-1] - x) == d            # d is exact
        cases.append((theta, d, x))
    params = dataclasses.replace(P, ou_theta=float(theta), vth_sigma=0.0)   # s_w = 0
    assert np.float32(params.ou_theta) == theta and np.float32(params.ou_sigma_w) == 0.0
    mu, x0 = np.array(mu, np.float32), np.array(x0, np.float32)
    assert all(_fma_twice_rounded(*c) != _fma_f32(*c) for c in cases), \
        "the constructed operands do not separate the two roundings"
    k = jax.random.PRNGKey(11)
    want = np.asarray(jax.jit(jdevice.sample_ou_path, static_argnums=(1, 2))(
        k, 3, params, jnp.asarray(mu), jnp.asarray(x0)))
    assert [_f32_bits(v) for v in want[0]] == [_f32_bits(_fma_f32(*c)) for c in cases]
    eps = torch.from_numpy(np.array(jax.random.normal(k, (3, len(mu)))))
    got = device.ou_scan(eps, torch.from_numpy(mu), torch.from_numpy(x0),
                         np.float32(params.ou_theta), np.float32(params.ou_sigma_w))
    np.testing.assert_array_equal(got.numpy(), want)


def test_ou_fma2_midpoint_operands_are_bit_exact():
    """fma(s_w, e, x) with mu = x, so the first FMA is x itself: for one of
    the reference's own draws e, s_w is chosen so that s_w * e is half a
    float32 ulp of x plus less than half a float64 ulp.  The old emulation
    ties to x; the FMA and the reference's compiled scan do not."""
    k = jax.random.PRNGKey(5)
    n = 64
    e = np.array(jax.random.normal(k, (1, n)))[0]
    ms = [int(np.abs(v).view(np.int32)) & 0x7FFFFF | 0x800000 for v in e]
    pick = None
    for i, m_e in enumerate(ms):
        m_s = -(-2**47 // m_e)
        if m_s < 2**24 and 0 < m_s * m_e - 2**47 < 2**17:
            pick = (i, m_s)
            break
    assert pick is not None, "no draw gives a midpoint"
    i, m_s = pick
    s_w = np.float32(m_s * 2.0**-26)                  # 0.125 <= s_w < 0.25
    c = np.sqrt(1.0 - (1.0 - P.ou_theta) ** 2)
    sigma = float(s_w) / c
    for _ in range(8):                                # vth_sigma whose s_w rounds to s_w
        if np.float32(sigma * c) == s_w:
            break
        sigma = np.nextafter(sigma, np.inf if np.float32(sigma * c) < s_w else -np.inf)
    params = dataclasses.replace(P, vth_sigma=sigma)
    assert np.float32(params.ou_sigma_w) == s_w
    # s_w * e = 2**(ee - 48) * (2**47 + d): half a float32 ulp of x at exponent ee + 22
    ee = int((np.abs(e[i]).view(np.int32) >> 23) & 0xFF) - 127
    x = np.full(n, np.float32(P.vth_mu), np.float32)
    x[i] = np.float32(1.5 * 2.0 ** (ee + 22))
    case = (s_w, e[i], x[i])
    assert _fma_twice_rounded(*case) != _fma_f32(*case)
    want = np.asarray(jax.jit(jdevice.sample_ou_path, static_argnums=(1, 2))(
        k, 1, params, jnp.asarray(x), jnp.asarray(x)))
    assert _f32_bits(want[0, i]) == _f32_bits(_fma_f32(*case))
    got = device.ou_scan(torch.from_numpy(e[None]), torch.from_numpy(x), torch.from_numpy(x),
                         np.float32(params.ou_theta), np.float32(params.ou_sigma_w))
    np.testing.assert_array_equal(got.numpy(), want)


def test_fig1_flows_are_bit_reproducible_across_runs_and_thread_counts():
    """The Fig 1 flows run twice, then once more on one thread: the same bits."""
    def flows():
        path = device.sample_ou_path(_kd(jax.random.PRNGKey(0)), 20000, device="cpu")
        mus = device.sample_devices(_kd(jax.random.PRNGKey(1)), 1000, device="cpu")
        hrs, lrs = device.endurance_trace(_kd(jax.random.PRNGKey(2)), 100000, device="cpu")
        fit = np.array(device.fit_ou(path))
        return [t.numpy().copy() for t in (path, mus, hrs, lrs)] + [fit]

    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        runs = [flows(), flows()]
        torch.set_num_threads(1)
        runs.append(flows())
    finally:
        torch.set_num_threads(threads)
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))
