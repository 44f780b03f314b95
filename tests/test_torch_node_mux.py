"""The port's node-MUX sweep and its bit/entropy primitives against the JAX reference.

Everything here is held bit for bit against ``repro`` computed in this
process, on the CPU: each kernel's plain torch version against the
reference's ``ref.py`` and against its Pallas kernel in interpret mode, the
ops level against the reference's ops, the root encoders of the unfused
lowering against the reference's ``rng`` and against the port's kernels'
entry points, and the packed gates and CORDIV against the reference's.  The
CUDA kernels are compared with their plain versions in
``test_torch_cuda_node_mux.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitops as jbitops
from repro.core import cordiv as jcordiv
from repro.core import logic as jlogic
from repro.core import rng as jrng
from repro.kernels.node_mux import kernel as jkernel
from repro.kernels.node_mux import ops as jops
from repro.kernels.node_mux import ref as jref
from repro_torch.core import bitops, cordiv, logic, rng
from repro_torch.kernels import node_mux, node_mux_categorical, sne_encode
from repro_torch.kernels.node_mux import ref

torch.set_num_threads(1)

WRAP = 2**32 - 300         # a counter origin whose draws wrap 2**32
# (k, parent cards): mixed parent cards, a 3-card parent (its 2 planes can
# spell digit 3), and P = 0 (a k-ary root)
CAT_CARDS = [(2, ()), (3, ()), (4, ()), (2, (3,)), (3, (2, 3)), (4, (3, 2)),
             (3, (4, 2, 3)), (2, (2, 2))]


def _key(seed):
    k = jax.random.PRNGKey(seed)
    return k, np.asarray(jax.random.key_data(k))


def _u32(words):
    """The port's int32 words -> uint32 numpy bit patterns."""
    return words.numpy().view(np.uint32)


def _i32(u32):
    """uint32 numpy words -> the port's int32 words."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(u32, np.uint32)).view(np.int32))


def _entropy(seed, shape, n_bits, offset=0):
    """(jnp uint32, torch int64) entropy words drawn at a counter origin."""
    jk, _ = _key(seed)
    words = np.asarray(jrng.counter_hash_words(jk, shape, n_bits // 4, offset=offset))
    return jnp.asarray(words), torch.from_numpy(words.astype(np.int64))


def _random_words(seed, shape):
    return np.random.default_rng(seed).integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _cpt(seed, rows, n_leaves):
    """CPT rows with the DAC half steps (2k+1)/512, 0, 1 and clipped values mixed in."""
    r = np.random.default_rng(seed)
    cpt = r.random((rows, n_leaves)).astype(np.float32)
    edge = np.array([1 / 512, 3 / 512, 255 / 512, 511 / 512, 0.0, 1.0, 1.5, -0.25], np.float32)
    flat = cpt.reshape(-1)
    flat[: min(flat.size, edge.size)] = edge[: min(flat.size, edge.size)]
    return cpt


def _cdf(seed, rows, n_leaves, k):
    """Non-increasing (R, L, k-1) DAC thresholds in [0, 256], 0 and 256 included."""
    r = np.random.default_rng(seed)
    cdf = -np.sort(-r.integers(0, 257, (rows, n_leaves, k - 1)), axis=-1)
    cdf.reshape(-1, k - 1)[0] = 256
    cdf.reshape(-1, k - 1)[-1] = 0
    return cdf.astype(np.uint32)


def _planes(cards):
    return sum(jbitops.value_bits(c) for c in cards)


# --- the three kernels' plain versions against ref.py and the Pallas kernels --------


@pytest.mark.parametrize("m", [0, 1, 2, 3])
@pytest.mark.parametrize("n_bits", [32, 256])
@pytest.mark.parametrize("offset", [0, WRAP])
def test_gather_plain_equals_reference_and_pallas(m, n_bits, offset):
    rows, w = 24, n_bits // 32
    cpt = _cpt(m + n_bits, rows, 1 << m)
    jrand, trand = _entropy(m, (rows,), n_bits, offset)
    par = _random_words(m + 7, (m, rows, w))
    got = _u32(ref.node_mux_gather_ref(torch.from_numpy(cpt), trand, _i32(par)))
    want = np.asarray(jref.node_mux_gather_ref(jnp.asarray(cpt), jrand, jnp.asarray(par)))
    np.testing.assert_array_equal(got, want)
    if not m:             # the reference's Pallas kernels cannot take zero parents
        return
    pallas = jkernel.node_mux_gather_pallas(jnp.asarray(cpt), jrand, jnp.asarray(par),
                                            block_r=8, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


@pytest.mark.parametrize("m", [0, 1, 2, 3])
@pytest.mark.parametrize("n_bits", [32, 256])
def test_rows_plain_equals_reference_and_pallas(m, n_bits):
    rows, w = 16, n_bits // 32
    cpt = _cpt(m, rows, 1 << m)
    jrand, trand = _entropy(m + 1, (rows, 1 << m), n_bits, WRAP if m % 2 else 0)
    par = _random_words(m + 3, (m, rows, w))
    got = _u32(ref.node_mux_ref(torch.from_numpy(cpt), trand, _i32(par)))
    want = np.asarray(jref.node_mux_ref(jnp.asarray(cpt), jrand, jnp.asarray(par)))
    np.testing.assert_array_equal(got, want)
    if not m:
        return
    pallas = jkernel.node_mux_pallas(jnp.asarray(cpt), jrand, jnp.asarray(par),
                                     block_r=8, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


@pytest.mark.parametrize("k,pcards", CAT_CARDS)
@pytest.mark.parametrize("n_bits", [32, 256])
def test_cat_plain_equals_reference_and_pallas(k, pcards, n_bits):
    rows, w = 16, n_bits // 32
    cards = (k,) + pcards
    n_leaves = int(np.prod(pcards)) if pcards else 1
    cdf = _cdf(k + n_bits, rows, n_leaves, k)
    jrand, trand = _entropy(len(pcards), (rows,), n_bits, WRAP)
    par = _random_words(k, (_planes(pcards), rows, w))
    got = _u32(ref.cat_gather_body(torch.from_numpy(cdf.astype(np.int64)), trand,
                                   _i32(par), cards))
    want = np.asarray(jref.cat_gather_body(jnp.asarray(cdf), jrand, jnp.asarray(par), cards))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (jbitops.value_bits(k), rows, w)
    if pcards:            # the reference's Pallas wrapper cannot take zero parents
        pallas = jkernel.node_mux_cat_pallas(jnp.asarray(cdf), jrand, jnp.asarray(par),
                                             cards=cards, block_r=8, interpret=True)
        np.testing.assert_array_equal(got, np.asarray(pallas))


# --- the places where a port that looks right differs -------------------------------


def test_interleaved_bit_layout_of_the_gather():
    """Stream bit 4e + b comes from byte b of entropy word e, at bit 4(e % 8) + b."""
    rand = torch.zeros((1, 8), dtype=torch.int64)
    rand[0, 3] = 0xFF00FF00           # word 3: bytes 1 and 3 are 255, bytes 0 and 2 are 0
    cpt = torch.tensor([[0.5]])
    out = _u32(ref.node_mux_gather_ref(cpt, rand, torch.zeros((0, 1, 1), dtype=torch.int32)))
    bits = [(int(out[0, 0]) >> i) & 1 for i in range(32)]
    want = [1] * 32
    want[4 * 3 + 1] = want[4 * 3 + 3] = 0
    assert bits == want


def test_first_parent_is_the_most_significant_row_bit():
    # rows 0..3 of (p0, p1): only row 2 (p0 = 1, p1 = 0) is always 1
    cpt = torch.tensor([[0.0, 0.0, 1.0, 0.0]])
    rand = torch.from_numpy(_random_words(1, (1, 8)).astype(np.int64))
    p0, p1 = 0x0F0F0F0F, 0x00FF00FF
    par = _i32(np.array([[[p0]], [[p1]]], np.uint32))
    got = int(_u32(ref.node_mux_gather_ref(cpt, rand, par))[0, 0])
    assert got == p0 & ~p1 & 0xFFFFFFFF
    rows_rand = torch.from_numpy(_random_words(2, (1, 4, 8)).astype(np.int64))
    assert int(_u32(ref.node_mux_ref(cpt, rows_rand, par))[0, 0]) == got


def test_dac_rounding_half_even_and_256_is_always_one():
    ks = np.arange(256)
    cpt = ((2 * ks + 1) / 512).astype(np.float32).reshape(-1, 1)
    thresh = rng.threshold_from_p(torch.from_numpy(cpt))[:, 0].numpy()
    np.testing.assert_array_equal(thresh, np.round((2 * ks + 1) / 2))     # half to even
    np.testing.assert_array_equal(thresh, np.asarray(jrng.threshold_from_p(cpt))[:, 0])
    rand = torch.full((2, 8), 0xFFFFFFFF, dtype=torch.int64)             # every byte 255
    none = torch.zeros((0, 2, 1), dtype=torch.int32)
    out = _u32(ref.node_mux_gather_ref(torch.tensor([[1.0], [255 / 256]]), rand, none))
    assert out[0, 0] == 0xFFFFFFFF and out[1, 0] == 0


def test_cat_digit_past_the_cardinality_selects_digit_zero():
    # parent card 3: planes (1, 1) spell digit 3, which must read CPT row 0
    cdf = torch.tensor([[[256, 256], [0, 0], [0, 0]]])       # row 0: always value 2
    rand = torch.from_numpy(_random_words(3, (1, 8)).astype(np.int64))
    par = _i32(np.full((2, 1, 1), 0xFFFFFFFF, np.uint32))
    got = _u32(ref.cat_gather_body(cdf, rand, par, (3, 3)))
    assert got[0, 0, 0] == 0 and got[1, 0, 0] == 0xFFFFFFFF  # value 2 everywhere
    want = np.asarray(jref.cat_gather_body(jnp.asarray(cdf.numpy().astype(np.uint32)),
                                           jnp.asarray(rand.numpy().astype(np.uint32)),
                                           jnp.asarray(_u32(par)), (3, 3)))
    np.testing.assert_array_equal(got, want)


def test_cat_value_is_the_count_of_levels_not_the_first_index():
    # an increasing CDF row (not what a spec lowers to): byte 100 lies below
    # levels 2 and 3 only, so the value is 2, where "first level" would say 1
    cdf = torch.tensor([[[50, 150, 200]]])
    rand = torch.full((1, 8), 100 * 0x01010101, dtype=torch.int64)
    got = _u32(ref.cat_gather_body(cdf, rand, torch.zeros((0, 1, 1), dtype=torch.int32),
                                   (4,)))
    assert got[0, 0, 0] == 0 and got[1, 0, 0] == 0xFFFFFFFF
    want = np.asarray(jref.cat_gather_body(jnp.asarray(cdf.numpy().astype(np.uint32)),
                                           jnp.asarray(rand.numpy().astype(np.uint32)),
                                           jnp.zeros((0, 1, 1), jnp.uint32), (4,)))
    np.testing.assert_array_equal(got, want)


# --- the ops level -------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["gather", "rows"])
@pytest.mark.parametrize("lead", [(), (5,), (2, 3)])
def test_node_mux_matches_reference_ops(mode, lead):
    m, n_bits = 2, 128
    jk, tk = _key(9)
    cpt = _cpt(4, int(np.prod(lead)) if lead else 1, 1 << m).reshape(lead + (1 << m,))
    par = _random_words(5, (m,) + lead + (n_bits // 32,))
    want = np.asarray(jops.node_mux(jk, jnp.asarray(cpt), jnp.asarray(par), n_bits,
                                    mode=mode, use_kernel=False))
    got = _u32(node_mux(tk, torch.from_numpy(cpt), _i32(par), n_bits, mode=mode,
                        device="cpu"))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,pcards", [(3, (2, 3)), (4, (4,)), (2, (3, 2))])
@pytest.mark.parametrize("lead", [(), (6,)])
def test_node_mux_categorical_matches_reference_ops(k, pcards, lead):
    n_bits = 64
    jk, tk = _key(k)
    n_leaves = int(np.prod(pcards))
    cdf = _cdf(1, int(np.prod(lead)) if lead else 1, n_leaves, k).reshape(
        lead + (n_leaves, k - 1))
    par = _random_words(2, (_planes(pcards),) + lead + (n_bits // 32,))
    want = np.asarray(jops.node_mux_categorical(jk, jnp.asarray(cdf), jnp.asarray(par),
                                                cards=(k,) + pcards, n_bits=n_bits,
                                                use_kernel=False))
    got = _u32(node_mux_categorical(tk, torch.from_numpy(cdf.astype(np.int64)), _i32(par),
                                    cards=(k,) + pcards, n_bits=n_bits, device="cpu"))
    np.testing.assert_array_equal(got, want)


def test_ops_validate_and_default_to_the_card():
    _, tk = _key(0)
    cpt = torch.full((4,), 0.5)
    with pytest.raises(ValueError):
        node_mux(tk, cpt, torch.zeros((1, 2), dtype=torch.int32), 64, device="cpu")
    with pytest.raises(ValueError):
        node_mux(tk, cpt, torch.zeros((2, 2), dtype=torch.int32), 64, mode="tree",
                 device="cpu")
    with pytest.raises(ValueError):
        node_mux(tk, cpt, torch.zeros((2, 2), dtype=torch.int32), 48, device="cpu")
    with pytest.raises(ValueError):
        node_mux_categorical(tk, torch.zeros((1, 2)), torch.zeros((0, 2), dtype=torch.int32),
                             cards=(4,), n_bits=64, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            node_mux(tk, cpt, torch.zeros((2, 2), dtype=torch.int32), 64)
        with pytest.raises(RuntimeError, match="CUDA"):
            node_mux_categorical(tk, torch.zeros((1, 2)), torch.zeros((0, 2), dtype=torch.int32),
                                 cards=(3,), n_bits=64)


# --- the unfused lowering's root encoders -------------------------------------------


@pytest.mark.parametrize("shape", [(), (7,), (2, 5)])
@pytest.mark.parametrize("n_bits", [64, 100, 256])
def test_binary_root_identity_encode_packed_equals_sne_encode(shape, n_bits):
    jk, tk = _key(21)
    p = _cpt(3, 1, int(np.prod(shape)) if shape else 1).reshape(shape)
    want = np.asarray(jrng.encode_packed(jk, jnp.asarray(p), n_bits))
    got = _u32(rng.encode_packed(tk, torch.from_numpy(p), n_bits))
    np.testing.assert_array_equal(got, want)
    if n_bits % 32 == 0:   # sne_encode takes whole words, as the unfused lowering does
        np.testing.assert_array_equal(
            _u32(sne_encode(tk, torch.from_numpy(p), n_bits, device="cpu")), want)


@pytest.mark.parametrize("cdf", [(128,), (200, 90), (256, 130, 0), (180, 180, 40)])
@pytest.mark.parametrize("batch", [None, 6])
def test_kary_root_identity_encode_categorical_equals_cat_with_no_parents(cdf, batch):
    n_bits = 128
    jk, tk = _key(5)
    want = np.asarray(jrng.encode_packed_categorical(jk, cdf, n_bits, batch=batch))
    got = rng.encode_packed_categorical(tk, cdf, n_bits, batch=batch)
    np.testing.assert_array_equal(_u32(got), want)
    lead = () if batch is None else (batch,)
    table = torch.tensor([cdf], dtype=torch.int32).expand(lead + (1, len(cdf)))
    planes = node_mux_categorical(tk, table, torch.zeros((0,) + lead + (n_bits // 32,),
                                                         dtype=torch.int32),
                                  cards=(len(cdf) + 1,), n_bits=n_bits, device="cpu")
    np.testing.assert_array_equal(_u32(planes), want)


def test_random_words_match_the_reference_fast_generator():
    jk, tk = _key(3)
    want = np.asarray(jrng.random_words(jk, (3, 2), 96, impl="fast"))
    np.testing.assert_array_equal(rng.random_words(tk, (3, 2), 96).numpy(),
                                  want.astype(np.int64))


# --- packed gates, the MUX tree and CORDIV ------------------------------------------


@pytest.mark.parametrize("n_bits", [1, 31, 32, 77, 256])
def test_pack_unpack_decode_bnot_match_reference(n_bits):
    bits = np.random.default_rng(n_bits).integers(0, 2, (3, n_bits)).astype(np.uint8)
    words = np.asarray(jbitops.pack_bits(jnp.asarray(bits)))
    got = bitops.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(_u32(got), words)
    np.testing.assert_array_equal(bitops.unpack_bits(got, n_bits).numpy(),
                                  np.asarray(jbitops.unpack_bits(jnp.asarray(words), n_bits)))
    np.testing.assert_array_equal(bitops.decode(got, n_bits).numpy(),
                                  np.asarray(jbitops.decode(jnp.asarray(words), n_bits)))
    np.testing.assert_array_equal(_u32(bitops.bnot(got, n_bits)),
                                  np.asarray(jbitops.bnot(jnp.asarray(words), n_bits)))


def test_bmux_value_planes_and_mux_select_match_reference():
    a, b, s = (_random_words(i, (4, 3)) for i in range(3))
    np.testing.assert_array_equal(
        _u32(bitops.bmux(_i32(s), _i32(a), _i32(b))),
        np.asarray(jbitops.bmux(jnp.asarray(s), jnp.asarray(a), jnp.asarray(b))))
    lv = _random_words(4, (3, 5))
    lv[1] &= lv[0]
    lv[2] &= lv[1]                  # nested value >= v indicators
    want = jbitops.value_planes([jnp.asarray(x) for x in lv])
    got = bitops.value_planes([_i32(x) for x in lv])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u32(g), np.asarray(w))
    for m in range(4):
        sel = _random_words(10 + m, (m, 2, 3))
        leaves = _random_words(20 + m, (2, 1 << m, 3))
        np.testing.assert_array_equal(
            _u32(logic.mux_select(_i32(sel), _i32(leaves))),
            np.asarray(jlogic.mux_select(jnp.asarray(sel), jnp.asarray(leaves))))


@pytest.mark.parametrize("n_bits", [32, 100, 256])
def test_cordiv_fill_scan_ratio_match_reference(n_bits):
    nw = jbitops.n_words(n_bits)
    mask = np.asarray(jbitops.pad_mask(n_bits))
    d = _random_words(n_bits, (6, nw)) & mask
    d[1] = 0                                     # never high
    d[2, : nw // 2] = 0                          # high only in later words
    d[3] &= np.uint32(0x80000001)                # sparse: the held bit crosses words
    n = _random_words(n_bits + 1, (6, nw)) & d
    jq, je = jcordiv.cordiv_fill(jnp.asarray(n), jnp.asarray(d), n_bits)
    q, e = cordiv.cordiv_fill(_i32(n), _i32(d), n_bits)
    np.testing.assert_array_equal(_u32(q), np.asarray(jq))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    sq, se = cordiv.cordiv_scan(_i32(n), _i32(d), n_bits)
    np.testing.assert_array_equal(_u32(sq), _u32(q))
    np.testing.assert_array_equal(se.numpy(), e.numpy())
    np.testing.assert_array_equal(
        cordiv.cordiv_ratio(_i32(n), _i32(d)).numpy(),
        np.asarray(jcordiv.cordiv_ratio(jnp.asarray(n), jnp.asarray(d))))
