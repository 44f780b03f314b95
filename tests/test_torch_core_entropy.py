"""The paper layer's entropy against the JAX reference: the device Threefry,
``normal`` and ``erf_inv`` (``core/prng.py``), the bitwise gates
(``core/bitops.py``) and the encoders of ``core/rng.py`` under both entropy
generators.

Threefry words, uniforms, packed streams and counts are bit for bit.
``normal`` and ``erf_inv`` are XLA's float32 formulas operation for operation,
but the platforms' ``log1p`` and ``sqrt`` round apart: they are held within
NORMAL_ULP ulp (3 measured over 10**6 draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitops as jbitops
from repro.core import rng as jrng
from repro_torch.core import bitops, prng, rng

torch.set_num_threads(1)

NORMAL_ULP = 4
PART = bool(jax.config.jax_threefry_partitionable)


def _kd(k):
    return np.asarray(jax.random.key_data(k) if jnp.issubdtype(k.dtype, jax.dtypes.prng_key)
                      else k, np.uint32)


def _words(x):
    """Reference uint32 words as the port's int32 bit patterns."""
    return np.asarray(x).view(np.int32)


def _ulp(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
@pytest.mark.parametrize("shape", [(), (5,), (3, 7), (1001,), (2, 3, 4)])
def test_device_bits_and_uniform_equal_jax_random(seed, shape):
    k = jax.random.PRNGKey(seed)
    got = prng.device_bits(_kd(k), shape, device="cpu", partitionable=PART)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64))
    u = prng.device_uniform(_kd(k), shape, device="cpu", partitionable=PART)
    np.testing.assert_array_equal(u.numpy().view(np.uint32),
                                  np.asarray(jax.random.uniform(k, shape)).view(np.uint32))


@pytest.mark.parametrize("partitionable", [True, False])
def test_device_bits_equal_the_host_cipher_under_both_layouts(partitionable):
    key = prng.PRNGKey(11)
    for shape in ((1,), (6,), (7, 5)):
        np.testing.assert_array_equal(
            prng.device_bits(key, shape, device="cpu", partitionable=partitionable).numpy(),
            prng.random_bits(key, shape, partitionable=partitionable).astype(np.int64))


def test_device_bits_batched_keys_equal_per_key_draws():
    ks = jax.random.split(jax.random.PRNGKey(3), 6)
    got = prng.device_bits(np.asarray(ks), (2, 9), device="cpu", partitionable=PART).numpy()
    assert got.shape == (6, 2, 9)
    for i in range(6):
        np.testing.assert_array_equal(got[i], np.asarray(jax.random.bits(ks[i], (2, 9), jnp.uint32)))
    normals = prng.normal(np.asarray(ks), (50,), device="cpu", partitionable=PART).numpy()
    for i in range(6):
        assert _ulp(normals[i], jax.random.normal(ks[i], (50,))).max() <= NORMAL_ULP


@pytest.mark.parametrize("seed", [1, 2])
def test_normal_within_ulp_of_jax_random_normal(seed):
    k = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.normal(k, (1 << 17,)))
    got = prng.normal(_kd(k), (1 << 17,), device="cpu", partitionable=PART).numpy()
    assert got.dtype == np.float32
    d = _ulp(got, want)
    assert d.max() <= NORMAL_ULP
    assert (d == 0).mean() > 0.9            # most draws are bit-equal
    assert abs(got.mean()) < 0.02 and abs(got.std() - 1) < 0.02


def test_erf_inv_is_xlas_polynomial_not_torch_erfinv():
    x = np.random.default_rng(0).uniform(-1, 1, 1 << 17).astype(np.float32)
    x[:5] = [1.0, -1.0, 0.0, np.nextafter(np.float32(-1), np.float32(0)), 0.999999]
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = prng.erf_inv(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got[:3], want[:3])       # +-inf and 0 exactly
    assert _ulp(got[3:], want[3:]).max() <= NORMAL_ULP
    # torch.erfinv is another function: far more than a few ulp apart
    assert _ulp(torch.erfinv(torch.from_numpy(x[3:])).numpy(), want[3:]).max() > 8 * NORMAL_ULP


@pytest.mark.parametrize("seed", [0, 1])
def test_gates_equal_reference(seed):
    r = np.random.default_rng(seed)
    a, b = (r.integers(0, 2**32, (3, 5), dtype=np.uint64).astype(np.uint32) for _ in range(2))
    ta, tb = torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32))
    for jf, tf in ((jbitops.band, bitops.band), (jbitops.bor, bitops.bor),
                   (jbitops.bxor, bitops.bxor)):
        np.testing.assert_array_equal(tf(ta, tb).numpy(), _words(jf(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("impl", ["fast", "threefry"])
@pytest.mark.parametrize("n_bits", [100, 128, 1000])
def test_random_words_and_fair_bits_equal_reference(impl, n_bits):
    k = jax.random.PRNGKey(n_bits)
    got = rng.random_words(_kd(k), (3,), n_bits, impl)
    want = np.asarray(jrng.random_words(k, (3,), n_bits, impl=impl)).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)
    fb = rng.fair_bits(_kd(k), (2, 3), n_bits, impl=impl)
    np.testing.assert_array_equal(fb.numpy(), _words(jrng.fair_bits(k, (2, 3), n_bits, impl=impl)))
    if n_bits % 32:     # pad bits stay zero under both generators
        assert int(bitops.popcount(fb & ~bitops.pad_mask(n_bits)).max()) == 0


@pytest.mark.parametrize("impl", ["fast", "threefry"])
@pytest.mark.parametrize("n_bits", [100, 256])
def test_packed_encoders_equal_reference(impl, n_bits):
    r = np.random.default_rng(n_bits)
    k = jax.random.PRNGKey(5)
    p = r.uniform(-0.1, 1.1, (4, 6)).astype(np.float32)
    p[0, :4] = [1 / 512, 3 / 512, 255 / 512, 257 / 512]       # DAC half steps round to even
    np.testing.assert_array_equal(rng.encode_packed(_kd(k), p, n_bits, impl).numpy(),
                                  _words(jrng.encode_packed(k, p, n_bits, impl=impl)))
    neg = r.integers(0, 2, (4, 6)).astype(bool)
    for negate in (None, neg):
        got = rng.encode_packed_correlated(_kd(k), p, n_bits, negate=negate, impl=impl)
        want = jrng.encode_packed_correlated(k, p, n_bits, negate=negate, impl=impl)
        np.testing.assert_array_equal(got.numpy(), _words(want))
    for batch in (None, 3):
        got = rng.encode_packed_categorical(_kd(k), (230, 120, 9), n_bits, batch=batch, impl=impl)
        want = jrng.encode_packed_categorical(k, (230, 120, 9), n_bits, batch=batch, impl=impl)
        np.testing.assert_array_equal(got.numpy(), _words(want))


def test_negated_comparator_is_the_complement_byte():
    """``negate`` reads 255 - byte: at p and 1 - p (off the DAC half steps) a
    negated stream is the bitwise complement of the plain one."""
    key = prng.PRNGKey(9)
    p = torch.tensor([[0.3, 0.7]])
    words = rng.encode_packed_correlated(key, p, 256, negate=torch.tensor([[False, True]]))
    assert torch.equal(words[0, 1], ~words[0, 0])


def test_unknown_impl_raises():
    for call in (lambda: rng.random_words(prng.PRNGKey(0), (2,), 64, "philox"),
                 lambda: rng.fair_bits(prng.PRNGKey(0), (2,), 64, impl="philox")):
        with pytest.raises(ValueError, match="impl"):
            call()


# --- mirrors of tests/core/test_fast_paths.py's threefry cases ----------------------


def test_threefry_impl_available():
    w = rng.random_words(prng.PRNGKey(0), (2,), 128, "threefry")
    assert tuple(w.shape) == (2, 32) and w.dtype == torch.int64
    assert int(w.min()) >= 0 and int(w.max()) < 2**32


def test_fair_bits_threefry_end_to_end():
    """fair_bits(impl='threefry') draws exactly jax.random.bits words, in both
    packages, and differs from the counter-hash generator."""
    k = jax.random.PRNGKey(11)
    want = _words(jax.random.bits(k, (3, 4), jnp.uint32))
    for got in (np.asarray(jrng.fair_bits(k, (3,), 128, impl="threefry")).view(np.int32),
                rng.fair_bits(_kd(k), (3,), 128, impl="threefry").numpy()):
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(rng.fair_bits(_kd(k), (3,), 128).numpy(), want)
    s100 = rng.fair_bits(prng.PRNGKey(5), (), 100, impl="threefry")
    assert int(bitops.popcount(s100 & ~bitops.pad_mask(100))) == 0


@pytest.mark.parametrize("impl", ["fast", "threefry"])
def test_fair_bits_is_half(impl):
    n = 1 << 14
    sigma = 0.5 / np.sqrt(n)
    for est in (float(jbitops.decode(jrng.fair_bits(jax.random.PRNGKey(4), (), n, impl=impl), n)),
                float(bitops.decode(rng.fair_bits(prng.PRNGKey(4), (), n, impl=impl), n))):
        assert abs(est - 0.5) < 6 * sigma
