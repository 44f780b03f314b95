"""Wide nodes and the categorical pattern table, against the JAX reference, on the CPU.

The categorical kernel samples from a table folded on the host
(``node_mux.cat_table``): the parents' mixed-radix decode and the CDF rows
become one pattern table of ``2**P`` rows for ``P`` parent bit-planes.  Its
plain version (``cat_table_body``) is held bit for bit against the
reference's ``cat_gather_body`` and its Pallas kernel in interpret mode, at
P = 0..5, with digits past a parent's cardinality, per-row and shared
tables, and at k = 2 fed from a float CPT as the wide binary gather is.
Above ``PATTERN_PLANES`` planes the table is the CDF rows themselves.  Then
networks with a 7- and an 8-parent node compile and run on
``device="cpu"`` -- unfused, ``rows``, shared entropy and fused -- bit-equal
to the reference.  The CUDA kernels are held against these plain versions in
``test_torch_cuda_node_mux.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.bayesnet as R
from repro.core import rng as jrng
from repro.kernels.node_mux import kernel as jkernel
from repro.kernels.node_mux import ref as jref
import repro_torch.bayesnet as T
from repro_torch.core import bitops, prng, rng
from repro_torch.kernels.node_mux import cat_table, ref
from torch_wide_net import wide_spec

torch.set_num_threads(1)

WRAP = 2**32 - 300
# (k, parent cards) at P = 0..5 planes; cards 3 spell digit 3 on their 2 planes
FOLD_CARDS = [(3, ()), (2, (2,)), (4, (3,)), (4, (4, 2)), (3, (2, 3, 2)), (2, (3, 2, 2, 2))]


def _entropy(seed, rows, n_bits, offset=0):
    words = np.asarray(jrng.counter_hash_words(jax.random.PRNGKey(seed), (rows,), n_bits // 4,
                                               offset=offset))
    return jnp.asarray(words), torch.from_numpy(words.astype(np.int64))


def _words(seed, shape):
    return np.random.default_rng(seed).integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _i32(u32):
    return torch.from_numpy(np.ascontiguousarray(u32).view(np.int32))


def _u32(words):
    return words.numpy().view(np.uint32)


def _cdf(seed, lead, n_leaves, k):
    r = np.random.default_rng(seed)
    cdf = -np.sort(-r.integers(0, 257, lead + (n_leaves, k - 1)), axis=-1)
    cdf.reshape(-1, k - 1)[0] = 256
    cdf.reshape(-1, k - 1)[-1] = 0
    return cdf.astype(np.uint32)


def test_pattern_rows_decode_digits_first_parent_most_significant():
    # parent 0 (card 4) on planes 0-1, parent 1 (card 2) on plane 2
    assert ref.pattern_rows((4, 2)).tolist() == [0, 2, 4, 6, 1, 3, 5, 7]
    # digit 3 of a card-3 parent reads digit 0
    assert ref.pattern_rows((3,)).tolist() == [0, 1, 2, 0]
    assert ref.pattern_rows(()).tolist() == [0]
    assert ref.pattern_rows((2,) * 3).tolist() == [0, 4, 2, 6, 1, 5, 3, 7]


@pytest.mark.parametrize("shared", [False, True], ids=["per-row", "shared"])
@pytest.mark.parametrize("k,pcards", FOLD_CARDS)
def test_pattern_fold_equals_reference_and_pallas(k, pcards, shared):
    rows, n_bits = 16, 256
    cards = (k,) + pcards
    n_leaves = int(np.prod(pcards)) if pcards else 1
    cdf = _cdf(k + len(pcards), (rows,), n_leaves, k)
    if shared:
        cdf[:] = cdf[:1]
    jrand, trand = _entropy(len(pcards), rows, n_bits, WRAP)
    n_planes = sum(bitops.value_bits(c) for c in pcards)
    par = _words(k * 7 + n_planes, (n_planes, rows, n_bits // 32))
    table = cat_table(torch.from_numpy(cdf.astype(np.int64)), cards)
    assert table.dtype == torch.int16 and tuple(table.shape[-2:]) == (1 << n_planes, k - 1)
    if shared:
        table = table[0]
    got = _u32(ref.cat_table_body(table, trand, _i32(par), cards))
    want = np.asarray(jref.cat_gather_body(jnp.asarray(cdf), jrand, jnp.asarray(par), cards))
    np.testing.assert_array_equal(got, want)
    if pcards:            # the reference's Pallas wrapper cannot take zero parents
        pallas = jkernel.node_mux_cat_pallas(jnp.asarray(cdf), jrand, jnp.asarray(par),
                                             cards=cards, block_r=8, interpret=True)
        np.testing.assert_array_equal(got, np.asarray(pallas))


@pytest.mark.parametrize("m", [1, 3, 5])
def test_pattern_fold_at_k2_from_float_cpt_equals_reference_gather(m):
    """The wide gather's route: a float CPT rounded to thresholds by
    ``rint(cpt * 256)`` (half to even, the DAC half steps (2k+1)/512 among
    them), folded as a k = 2 node with one plane per parent."""
    rows, n_bits = 8, 128
    r = np.random.default_rng(m)
    cpt = r.random((rows, 1 << m)).astype(np.float32)
    flat = cpt.reshape(-1)
    steps = (2 * np.arange(flat.size) + 1) / 512
    flat[: min(flat.size, 24)] = steps[: min(flat.size, 24)]
    flat[-3:] = (0.0, 1.0, 1.5)
    jrand, trand = _entropy(m, rows, n_bits)
    par = _words(m, (m, rows, n_bits // 32))
    thresh = rng.threshold_from_p(torch.from_numpy(cpt))[..., None]     # (R, L, 1)
    table = cat_table(thresh, (2,) * (m + 1))
    got = _u32(ref.cat_table_body(table, trand, _i32(par), (2,) * (m + 1)))[0]
    want = np.asarray(jref.node_mux_gather_ref(jnp.asarray(cpt), jrand, jnp.asarray(par)))
    np.testing.assert_array_equal(got, want)
    pallas = jkernel.node_mux_gather_pallas(jnp.asarray(cpt), jrand, jnp.asarray(par),
                                            block_r=8, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


@pytest.mark.parametrize("k,pcards", [(3, (2,) * 9), (2, (3, 2, 3, 2, 2))])
def test_wide_table_is_the_cdf_and_equals_reference(k, pcards):
    rows, n_bits = 4, 64
    cards = (k,) + pcards
    n_planes = sum(bitops.value_bits(c) for c in pcards)
    cdf = _cdf(n_planes, (), int(np.prod(pcards)), k)
    table = cat_table(torch.from_numpy(cdf.astype(np.int64)), cards)
    if n_planes > ref.PATTERN_PLANES:
        assert table.dtype == torch.int32 and torch.equal(table, torch.from_numpy(
            cdf.astype(np.int64)).to(torch.int32))
    jrand, trand = _entropy(n_planes, rows, n_bits)
    par = _words(n_planes, (n_planes, rows, n_bits // 32))
    got = _u32(ref.cat_table_body(table, trand, _i32(par), cards))
    want = np.asarray(jref.cat_gather_body(jnp.asarray(np.broadcast_to(cdf, (rows,) + cdf.shape)),
                                           jrand, jnp.asarray(par), cards))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["unfused", "rows", "shared", "fused"])
@pytest.mark.parametrize("m", [7, 8])
def test_wide_network_matches_reference(m, mode):
    kw = {"unfused": dict(fused=False), "rows": dict(mux_mode="rows"),
          "shared": dict(share_entropy=True), "fused": {}}[mode]
    rnet = R.compile_network(wide_spec(R, m), n_bits=256, **kw)
    tnet = T.compile_network(wide_spec(T, m), n_bits=256, device="cpu", **kw)
    assert tnet.fused == (mode == "fused")
    r = np.random.default_rng(m)
    ev = np.stack([r.integers(0, 2, 8), r.integers(0, 2, 8)], 1).astype(np.int32)
    want = rnet.decide(jax.random.PRNGKey(3), ev)
    got = tnet.decide(prng.PRNGKey(3), ev)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
