"""Port primitives against the JAX reference: bit words, entropy, thresholds, keys.

Inputs are fixed numpy seeds; JAX runs on the CPU.  Everything here is exact
integer arithmetic, so every comparison is bit for bit.
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

from repro.core import bitops as jbitops
from repro.core import rng as jrng
from repro_torch.core import bitops, prng, rng

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]

# counters straddling the 2**31 sign bit and the 2**32 wrap
_EDGE = np.array(
    [0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE, 0xFFFFFFFF,
     0x846CA68B, 0x7FEB352D, 123456789],
    np.uint64,
)


def _counters(seed):
    r = np.random.default_rng(seed)
    rand = r.integers(0, 2**32, 512, dtype=np.uint64)
    return np.concatenate([_EDGE, rand])


def _t(u):
    return torch.from_numpy(np.asarray(u, np.uint64).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lowbias32_bit_exact_across_wrap(seed):
    x = _counters(seed)
    want = np.asarray(jrng._lowbias32(jnp.asarray(x.astype(np.uint32))))
    got = rng._lowbias32(_t(x)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("c", [0x7FEB352D, 0x846CA68B, 0xFFFFFFFF, 1, 0])
def test_mul32_wraps_to_low_32_bits(c):
    x = _counters(3)
    want = (x * np.uint64(c)) & np.uint64(0xFFFFFFFF)   # uint64 wraps mod 2**64
    np.testing.assert_array_equal(rng.mul32(_t(x), c).numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("plane", range(8))
def test_plane_words_bit_exact(seed, plane):
    r = np.random.default_rng(100 + seed)
    kd0, kd1 = (int(v) for v in r.integers(0, 2**32, 2, dtype=np.uint64))
    ctr = _counters(seed)
    jb = jrng.plane_base(jnp.asarray(ctr.astype(np.uint32)), jnp.uint32(kd0))
    jw = jrng.plane_word(jb, jnp.uint32(kd1), plane)
    tb = rng.plane_base(_t(ctr), kd0)
    tw = rng.plane_word(tb, kd1, plane)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb).astype(np.int64))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).astype(np.int64))


def test_int32_word_views_round_trip():
    x = _counters(4)
    words = bitops.as_i32(_t(x))
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy().view(np.uint32), x.astype(np.uint32))
    np.testing.assert_array_equal(bitops.as_u32(words).numpy(), x.astype(np.int64))
    # the gate operators act on the bit pattern, whatever the sign
    y = _counters(5)[: len(x)]
    yw = bitops.as_i32(_t(y))
    for op in (np.bitwise_and, np.bitwise_or, np.bitwise_xor):
        want = op(x.astype(np.uint32), y.astype(np.uint32))
        got = op(words.numpy(), yw.numpy()).view(np.uint32)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal((~words).numpy().view(np.uint32), ~x.astype(np.uint32))


@pytest.mark.parametrize("seed", [0, 1])
def test_swar_popcount_matches_reference(seed):
    x = _counters(seed)
    want = np.asarray(jbitops.popcount_words(jnp.asarray(x.astype(np.uint32))))
    got = bitops.popcount_words(bitops.as_i32(_t(x))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int32))
    rows = bitops.as_i32(_t(x[:520])).reshape(8, 65)
    want_rows = np.asarray(jbitops.popcount(jnp.asarray(x[:520].astype(np.uint32)).reshape(8, 65)))
    np.testing.assert_array_equal(bitops.popcount(rows).numpy(), want_rows)


@pytest.mark.parametrize("n_bits", [1, 31, 32, 33, 100, 1024])
def test_pad_mask_matches_reference(n_bits):
    want = np.asarray(jbitops.pad_mask(n_bits))
    np.testing.assert_array_equal(bitops.pad_mask(n_bits).numpy().view(np.uint32), want)


def test_threshold_int_half_even_at_dac_boundaries():
    # p = (2k+1)/512 sits exactly on the half step between k and k+1
    for k in range(256):
        p = (2 * k + 1) / 512
        t = rng.threshold_int(p)
        assert t == jrng.threshold_int(p)
        assert t == (k if k % 2 == 0 else k + 1)
        assert t == int(np.asarray(jrng.threshold_from_p(jnp.float32(p))))
    for p in (-0.5, 0.0, 1.0, 1.5, 1e-9, 0.999):
        assert rng.threshold_int(p) == jrng.threshold_int(p)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cdf_thresholds_match_reference(seed):
    r = np.random.default_rng(seed)
    for k in (2, 3, 4, 5):
        for _ in range(20):
            probs = r.dirichlet(np.ones(k))
            assert rng.cdf_thresholds_int(tuple(probs)) == jrng.cdf_thresholds_int(tuple(probs))
    assert rng.cdf_thresholds_int((0.5, 0.5)) == jrng.cdf_thresholds_int((0.5, 0.5))


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 12345, 2**31 - 1])
def test_prng_key_lineage_matches_jax(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed)
    np.testing.assert_array_equal(prng.key_data(tk), np.asarray(jax.random.key_data(jk)))
    np.testing.assert_array_equal(rng.seed_words(tk), np.asarray(jrng.seed_words(jk)))
    for data in (0, 1, 2, 3, 255, 2**31 - 1, 2**31, 2**32 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(tk, data), np.asarray(jax.random.key_data(jax.random.fold_in(jk, data)))
        )
    # split under whichever threefry key layout this jax process uses
    mode = bool(jax.config.jax_threefry_partitionable)
    for num in (2, 3, 5):
        np.testing.assert_array_equal(
            prng.split(tk, num, partitionable=mode),
            np.asarray(jax.random.key_data(jax.random.split(jk, num))),
        )
    # a chain of the driver's own derivations: salt, launch counter, split
    jchain = jax.random.fold_in(jax.random.fold_in(jk, 9), 4)
    tchain = prng.fold_in(prng.fold_in(tk, 9), 4)
    np.testing.assert_array_equal(tchain, np.asarray(jax.random.key_data(jchain)))


def test_split_layouts_are_the_two_threefry_modes():
    k = prng.PRNGKey(3)
    part = prng.split(k, 4, partitionable=True)
    for i in range(4):
        np.testing.assert_array_equal(part[i], prng.fold_in(k, i))
    orig = prng.split(k, 2, partitionable=False)
    x = [prng.threefry2x32(0, 3, 0, 2), prng.threefry2x32(0, 3, 1, 3)]
    np.testing.assert_array_equal(orig.reshape(-1), [x[0][0], x[1][0], x[0][1], x[1][1]])


def _subprocess_modules(code):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


_LIST_MODULES = (
    "import sys; "
    "print(' '.join(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
    "or m == 'repro' or m.startswith('repro.') or m == 'repro_torch'))"
)


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n" + _LIST_MODULES.replace("; ", "\n")
    )
    assert _subprocess_modules(code) == {"repro_torch"}


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    code = "import chip_smoke\n" + _LIST_MODULES.replace("; ", "\n")
    assert not {m for m in _subprocess_modules(code) if m != "repro_torch"}
