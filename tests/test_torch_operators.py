"""The port's fusion operators against the JAX reference, on the CPU.

Counter-hash entropy, DAC thresholds, packed streams, counts and decisions
are held bit for bit against ``repro`` computed in this process: each
kernel's plain torch version against the reference's ``ref.py`` and against
its Pallas kernel in interpret mode, and the ops level against the
reference's ops.  Float outputs (``fusion_map``, ``fuse_analytic``) are held
within atol 2e-6, rtol 1e-5: the port and the reference evaluate the same
float32 log/exp expression, but the libraries' log and exp and the order of
the sums may differ in the last bits.  The CUDA kernels are compared with
their plain versions in ``test_torch_cuda_operators.py``.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_bayes as jcfg
from repro.core import fusion as jfusion
from repro.core import rng as jrng
from repro.data import detection as jdet
from repro.kernels.bayes_decide.kernel import bayes_decide_pallas
from repro.kernels.bayes_decide.ops import bayes_decide as jbayes_decide
from repro.kernels.bayes_decide.ops import bayes_decide_packed as jbayes_decide_packed
from repro.kernels.bayes_decide.ref import bayes_decide_ref as jbayes_decide_ref
from repro.kernels.fusion_map.kernel import fusion_map_pallas
from repro.kernels.fusion_map.ops import fusion_map as jfusion_map
from repro.kernels.fusion_map.ref import fusion_map_ref as jfusion_map_ref
from repro.kernels.pand_popcount.kernel import pand_popcount_pallas
from repro.kernels.pand_popcount.ops import pand_popcount as jpand_popcount
from repro.kernels.pand_popcount.ref import pand_popcount_ref as jpand_popcount_ref
from repro.kernels.sne_encode.kernel import sne_encode_pallas
from repro.kernels.sne_encode.ops import sne_encode as jsne_encode
from repro.kernels.sne_encode.ref import sne_encode_ref as jsne_encode_ref
from repro.models import bayes_head as jhead
from repro_torch.configs import paper_bayes as tcfg
from repro_torch.core import fusion as tfusion
from repro_torch.core import prng, rng
from repro_torch.data import detection as tdet
from repro_torch.kernels import bayes_decide, bayes_decide_packed, fusion_map
from repro_torch.kernels import pand_popcount, sne_encode
from repro_torch.kernels.bayes_decide.ref import bayes_decide_ref
from repro_torch.kernels.fusion_map.ref import fusion_map_ref
from repro_torch.kernels.pand_popcount.ref import pand_popcount_ref
from repro_torch.kernels.sne_encode.ref import sne_encode_ref
from repro_torch.models import bayes_head as thead

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL, RTOL = 2e-6, 1e-5
WRAP = 2**32 - 37          # a counter origin whose draws wrap 2**32


def _key(seed):
    """(JAX key, the port's (2,) uint32 key data) for one seed."""
    k = jax.random.PRNGKey(seed)
    return k, np.asarray(jax.random.key_data(k))


def _words(u32):
    """uint32 numpy words -> the port's int64 carrier."""
    return torch.from_numpy(np.asarray(u32).astype(np.int64))


def _u32(words):
    """The port's int32 words -> uint32 numpy bit patterns."""
    return words.numpy().view(np.uint32)


def _probs(seed, shape, zero_rows=()):
    """Uniform probabilities with exact DAC half steps and clipped values mixed in."""
    r = np.random.default_rng(seed)
    p = r.random(shape).astype(np.float32)
    flat = p.reshape(-1)
    picks = r.choice(flat.size, size=min(flat.size, 8), replace=False)
    flat[picks] = np.array([0.0, 1.0, 1.5, -0.2, 1 / 512, 3 / 512, 255 / 512, 511 / 512],
                           np.float32)[: len(picks)]
    for row in zero_rows:          # all-zero rows: every class ties at count 0
        p[:, row] = 0.0
    return p


# --- entropy, thresholds, packing ---------------------------------------------


@pytest.mark.parametrize("shape,n_words", [((5,), 8), ((2, 3, 4), 16), ((3, 1, 7), 3), ((), 8)])
@pytest.mark.parametrize("offset", [0, 7, WRAP, 2**32 + 17])
@pytest.mark.parametrize("seed", [0, 11])
def test_counter_hash_words_bit_exact(shape, n_words, offset, seed):
    jk, tk = _key(seed)
    want = np.asarray(jrng.counter_hash_words(jk, shape, n_words, offset=offset))
    got = rng.counter_hash_words(tk, shape, n_words, offset=offset)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape + (n_words,)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("shape", [(4, 3, 5), (1,), (7, 9)])
@pytest.mark.parametrize("offset", [0, WRAP])
def test_counter_iota_matches_reference(shape, offset):
    want = np.asarray(jrng.counter_iota(shape, offset)).astype(np.int64)
    np.testing.assert_array_equal(rng.counter_iota(shape, offset).numpy(), want)


@pytest.mark.parametrize("n_bits", [1, 31, 32, 100, 128, 4096])
def test_n_rand_words_matches_reference(n_bits):
    assert rng.n_rand_words(n_bits) == jrng.n_rand_words(n_bits)
    assert rng.BITS_PER_RAND_WORD == jrng.BITS_PER_RAND_WORD
    assert rng.RAND_WORDS_PER_OUT_WORD == jrng.RAND_WORDS_PER_OUT_WORD


def test_threshold_from_p_half_even_at_dac_boundaries():
    # p = (2k+1)/512 sits exactly on the half step between k and k+1
    half = (2 * np.arange(256) + 1) / 512
    extra = np.array([-1.0, -0.0, 0.0, 1e-9, 0.5, 0.999, 1.0, 1.0001, 7.0])
    p = np.concatenate([half, extra]).astype(np.float32)
    got = rng.threshold_from_p(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jrng.threshold_from_p(p)).astype(np.int64))
    k = np.arange(256)
    np.testing.assert_array_equal(got[:256], np.where(k % 2 == 0, k, k + 1))


@pytest.mark.parametrize("with_flip", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_packed_from_bytes_with_flip(with_flip, seed):
    jk, _ = _key(seed)
    rand = np.asarray(jrng.counter_hash_words(jk, (3, 5), 24))
    p = _probs(seed, (3, 5))
    flip = np.random.default_rng(seed).random((3, 5)) < 0.5 if with_flip else None
    want = np.asarray(jrng.packed_from_bytes(jnp.asarray(rand), jrng.threshold_from_p(p),
                                             None if flip is None else jnp.asarray(flip)))
    got = rng.packed_from_bytes(_words(rand), rng.threshold_from_p(torch.from_numpy(p)),
                                None if flip is None else torch.from_numpy(flip))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got), want)
    # a broadcast threshold (one per column) packs the same way
    want_b = np.asarray(jrng.packed_from_bytes(jnp.asarray(rand), jnp.uint32(130)))
    np.testing.assert_array_equal(_u32(rng.packed_from_bytes(_words(rand), 130)), want_b)


# --- each kernel's plain version against ref.py and the Pallas kernel -----------


@pytest.mark.parametrize("rows,block", [(8, 8), (64, 32), (96, 32), (40, 8)])
@pytest.mark.parametrize("n_bits", [32, 128])
def test_sne_encode_plain_version_bit_exact(rows, block, n_bits):
    jk, _ = _key(rows + n_bits)
    p = _probs(rows, (rows,))
    rand = np.asarray(jrng.counter_hash_words(jk, (rows,), n_bits // 4))
    got = _u32(sne_encode_ref(torch.from_numpy(p), _words(rand)))
    np.testing.assert_array_equal(got, np.asarray(jsne_encode_ref(p, rand)))
    pallas = sne_encode_pallas(jnp.asarray(p), jnp.asarray(rand), block_r=block, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("rows,words,block", [(16, 1, 8), (48, 4, 16), (40, 3, 8)])
def test_pand_popcount_plain_version_bit_exact(m, rows, words, block):
    r = np.random.default_rng(m * 100 + rows)
    streams = r.integers(0, 2**32, (m, rows, words), dtype=np.uint64).astype(np.uint32)
    streams[:, 0] = 0xFFFFFFFF           # rows at the count's extremes
    streams[0, 1] = 0
    got = pand_popcount_ref(torch.from_numpy(streams.view(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpand_popcount_ref(streams)))
    pallas = pand_popcount_pallas(jnp.asarray(streams), block_r=block, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    # the int64 carrier counts the same bits
    np.testing.assert_array_equal(pand_popcount_ref(_words(streams)).numpy(), got.numpy())


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("rows,block", [(16, 8), (24, 8)])
def test_bayes_decide_plain_version_bit_exact(m, k, rows, block):
    jk, _ = _key(10 * m + k)
    p = _probs(rows + k, (m, rows, k), zero_rows=(1, 5))
    rand = np.asarray(jrng.counter_hash_words(jk, (m, rows, k), 16))     # 64-bit streams
    dec, cnt = bayes_decide_ref(torch.from_numpy(p), _words(rand))
    assert dec.dtype == torch.int32 and cnt.dtype == torch.int32
    for jdec, jcnt in (jbayes_decide_ref(p, rand),
                       bayes_decide_pallas(jnp.asarray(p), jnp.asarray(rand), block_r=block,
                                           interpret=True)):
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
        np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))
    assert int(dec[1]) == 0 and int(cnt[1].sum()) == 0    # all-zero counts decide 0


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("k", [1, 2, 5, 16])
@pytest.mark.parametrize("rows,block", [(16, 8), (32, 16)])
def test_fusion_map_plain_version_within_tolerance(m, k, rows, block):
    r = np.random.default_rng(m * 10 + k)
    p = r.dirichlet(np.ones(k), size=(m, rows)).astype(np.float32)
    p[:, 0] = 0.0                         # clipped to 1e-9 in the log
    prior = r.dirichlet(np.ones(k)).astype(np.float32)
    got = fusion_map_ref(torch.from_numpy(p), torch.from_numpy(prior)).numpy()
    np.testing.assert_allclose(got, np.asarray(jfusion_map_ref(p, prior)), atol=ATOL, rtol=RTOL)
    pallas = fusion_map_pallas(jnp.asarray(p), jnp.asarray(prior), block_r=block, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


# --- the ops level ----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 6, 3), (3, 2, 4, 5), (1, 9, 2), (2, 5, 1)])
@pytest.mark.parametrize("n_bits", [32, 128])
@pytest.mark.parametrize("seed", [0, 3])
def test_bayes_decide_ops_fused_packed_and_composed_agree(shape, n_bits, seed):
    jk, tk = _key(seed)
    p = _probs(seed, shape, zero_rows=(0,))
    m, k = shape[0], shape[-1]
    jdec, jcnt = jbayes_decide(jk, p, n_bits)
    jdec_p, jcnt_p = jbayes_decide_packed(jk, p, n_bits)
    dec, cnt = bayes_decide(tk, p, n_bits, device="cpu")
    dec_p, cnt_p = bayes_decide_packed(tk, p, n_bits, device="cpu")
    streams = sne_encode(tk, p, n_bits, device="cpu")
    composed = pand_popcount(streams, device="cpu")
    for d, c in ((dec, cnt), (dec_p, cnt_p), (torch.argmax(composed, -1).to(torch.int32), composed)):
        assert tuple(c.shape) == shape[1:] and tuple(d.shape) == shape[1:-1]
        np.testing.assert_array_equal(c.numpy(), np.asarray(jcnt))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jdec))
    np.testing.assert_array_equal(np.asarray(jcnt_p), np.asarray(jcnt))
    np.testing.assert_array_equal(np.asarray(jdec_p), np.asarray(jdec))
    assert np.all(np.asarray(dec)[0] == 0)    # the p=0 row: all classes tie at 0
    assert cnt.max() <= n_bits


@pytest.mark.parametrize("shape", [(7,), (3, 4), (2, 2, 5)])
@pytest.mark.parametrize("n_bits", [32, 96])
def test_sne_encode_and_pand_popcount_ops_bit_exact(shape, n_bits):
    jk, tk = _key(sum(shape) + n_bits)
    p = _probs(n_bits, shape)
    want = np.array(jsne_encode(jk, p, n_bits))
    got = sne_encode(tk, p, n_bits, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == shape + (n_bits // 32,)
    np.testing.assert_array_equal(_u32(got), want)
    if len(shape) > 1:
        np.testing.assert_array_equal(pand_popcount(got, device="cpu").numpy(),
                                      np.asarray(jpand_popcount(jnp.asarray(want))))
        # uint32 numpy words are taken as their bit patterns
        np.testing.assert_array_equal(pand_popcount(want, device="cpu").numpy(),
                                      np.asarray(jpand_popcount(jnp.asarray(want))))


@pytest.mark.parametrize("offset", [0, 96, WRAP])
def test_slices_drawn_at_their_counter_origin(offset):
    """The kernels take a counter origin, and the full-size check on the card
    places each slice of rows by it: rows drawn at their own origin equal the
    same rows of the whole batch, and the whole batch equals the reference on
    the reference's words."""
    jk, tk = _key(4)
    m, r, k, n_bits = 2, 12, 3, 64
    n_rand = n_bits // 4
    p = torch.from_numpy(_probs(9, (m, r, k)))
    rand = rng.counter_hash_words(tk, (m, r, k), n_rand, offset=offset)
    jrand = np.asarray(jrng.counter_hash_words(jk, (m, r, k), n_rand, offset=offset))
    dec, cnt = bayes_decide_ref(p, rand)
    jdec, jcnt = jbayes_decide_ref(p.numpy(), jrand)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))
    whole = sne_encode_ref(p.reshape(-1), rand.reshape(-1, n_rand))
    np.testing.assert_array_equal(
        _u32(whole), np.asarray(jsne_encode_ref(p.numpy().reshape(-1), jrand.reshape(-1, n_rand))))
    # rows 4..8 of each modality, drawn at their own counter origin
    part = torch.stack([rng.counter_hash_words(tk, (4, k), n_rand,
                                               offset=offset + (mi * r + 4) * k * n_rand)
                        for mi in range(m)])
    assert torch.equal(part, rand[:, 4:8])
    part_dec, part_cnt = bayes_decide_ref(p[:, 4:8], part)
    assert torch.equal(part_dec, dec[4:8]) and torch.equal(part_cnt, cnt[4:8])
    words = sne_encode_ref(p[1, 4:8].reshape(-1), part[1].reshape(-1, n_rand))
    assert torch.equal(words, whole.view(m, r, k, -1)[1, 4:8].reshape(4 * k, -1))


@pytest.mark.parametrize("prior_kind", ["uniform", "dirichlet"])
@pytest.mark.parametrize("shape", [(2, 10, 2), (3, 4, 5, 4), (2, 7, 16)])
def test_fusion_map_ops_within_tolerance(prior_kind, shape):
    r = np.random.default_rng(len(shape) + shape[-1])
    p = r.dirichlet(np.ones(shape[-1]), size=shape[:-1]).astype(np.float32)
    prior = None if prior_kind == "uniform" else r.dirichlet(np.ones(shape[-1])).astype(np.float32)
    got = fusion_map(p, prior, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[1:]
    np.testing.assert_allclose(got.numpy(), np.asarray(jfusion_map(p, prior)), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("m,k", [(2, 2), (3, 5), (2, 16)])
@pytest.mark.parametrize("uniform", [False, True])
def test_fuse_analytic_and_unnormalized_within_tolerance(m, k, uniform):
    r = np.random.default_rng(m * k)
    p = r.dirichlet(np.ones(k), size=(4, 3, m)).astype(np.float32)    # (..., M, K)
    prior = None if uniform else r.dirichlet(np.ones(k)).astype(np.float32)
    np.testing.assert_allclose(tfusion.fuse_analytic(p, prior).numpy(),
                               np.asarray(jfusion.fuse_analytic(p, prior)), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tfusion.fuse_unnormalized_analytic(p, prior).numpy(),
                               np.asarray(jfusion.fuse_unnormalized_analytic(p, prior)),
                               atol=ATOL, rtol=RTOL)
    # fusion_map is fuse_analytic with the modality axis leading
    np.testing.assert_allclose(fusion_map(np.moveaxis(p, -2, 0), prior, device="cpu").numpy(),
                               tfusion.fuse_analytic(p, prior).numpy(), atol=ATOL, rtol=RTOL)


# --- entry points refuse a missing card -------------------------------------------


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs the kernels")
    key = np.array([1, 2], np.uint32)
    p = np.full((2, 3, 2), 0.5, np.float32)
    calls = [
        lambda: sne_encode(key, p),
        lambda: pand_popcount(np.zeros((2, 3, 1), np.int32)),
        lambda: bayes_decide(key, p),
        lambda: bayes_decide_packed(key, p),
        lambda: fusion_map(p),
        lambda: thead.fuse_posteriors(np.zeros((2, 1, 8), np.float32)),
        lambda: thead.fuse_posteriors_stochastic(key, np.zeros((2, 1, 8), np.float32)),
        lambda: tdet.make_scene(prng.PRNGKey(0), tdet.SceneConfig(height=16, width=16)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()


def test_ops_reject_bad_input():
    key = np.array([1, 2], np.uint32)
    p = np.full((2, 3, 2), 0.5, np.float32)
    for call in (lambda: sne_encode(key, p, 100, device="cpu"),
                 lambda: bayes_decide(key, p, 48, device="cpu"),
                 lambda: bayes_decide_packed(key, p, 0, device="cpu"),
                 lambda: bayes_decide(key, np.ones(3, np.float32), device="cpu"),
                 lambda: pand_popcount(np.zeros((2, 3), np.float32), device="cpu"),
                 lambda: fusion_map(np.ones(3, np.float32), device="cpu")):
        with pytest.raises(ValueError):
            call()


# --- the Bayes head ---------------------------------------------------------------


def _logits(seed, m=3, b=64, v=50):
    return np.random.default_rng(seed).normal(0.0, 2.0, (m, b, v)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuse_posteriors_matches_reference(seed):
    x = _logits(seed)
    jtok, jconf, jfused = jhead.fuse_posteriors(jnp.asarray(x), top_k=8)
    tok, conf, fused = thead.fuse_posteriors(x, top_k=8, device="cpu")
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(fused.numpy(), np.asarray(jfused), atol=ATOL, rtol=RTOL)
    acc, tok2 = thead.reliable_decision(tok, conf, threshold=0.5)
    jacc, _ = jhead.reliable_decision(jtok, jconf, threshold=0.5)
    assert torch.equal(tok2, tok)
    near = np.abs(np.asarray(jconf) - 0.5) <= 1e-5      # a gate within the tolerance may flip
    np.testing.assert_array_equal(acc.numpy()[~near], np.asarray(jacc)[~near])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuse_posteriors_stochastic_matches_reference(seed):
    """Tokens and confidences are equal except in a row where the two softmaxes
    put some ``p * 256`` on different sides of a DAC half step (the stated
    exception: the softmaxes may differ by an ulp); with continuous random
    logits no such row is expected, and at most one is allowed."""
    x = _logits(seed)
    jk, tk = _key(seed)
    jtok, jconf = jhead.fuse_posteriors_stochastic(jk, jnp.asarray(x), top_k=8, n_bits=256)
    tok, conf = thead.fuse_posteriors_stochastic(tk, x, top_k=8, n_bits=256, device="cpu")
    # the thresholds each side encodes
    _, cand = jax.lax.top_k(jnp.mean(jnp.asarray(x), 0), 8)
    jp = jax.nn.softmax(jnp.take_along_axis(jnp.asarray(x), cand[None].repeat(3, 0), -1), -1)
    _, tp = thead._candidates(x, 8, "cpu")
    same = np.all(np.asarray(jrng.threshold_from_p(jp)).astype(np.int64)
                  == rng.threshold_from_p(tp).numpy(), axis=(0, 2))
    assert same.sum() >= len(same) - 1
    np.testing.assert_array_equal(tok.numpy()[same], np.asarray(jtok)[same])
    np.testing.assert_allclose(conf.numpy()[same], np.asarray(jconf)[same], atol=ATOL, rtol=RTOL)


# --- data, config and the slice as a whole ----------------------------------------


def test_detection_metrics_on_a_reference_scene():
    cfg = jdet.SceneConfig(height=48, width=40, night_fraction=1.0)
    gt, p_rgb, p_th, _ = jdet.make_scene(jax.random.PRNGKey(3), cfg)
    for p in (p_rgb, p_th, 0.5 * (p_rgb + p_th)):
        want = jdet.detection_metrics(gt, p)
        got = tdet.detection_metrics(torch.from_numpy(np.array(gt)),
                                     torch.from_numpy(np.array(p)))
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g), float(w), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("night_fraction", [0.0, 1.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_scene_invariants(night_fraction, seed):
    cfg = tdet.SceneConfig(height=40, width=56, night_fraction=night_fraction)
    gt, p_rgb, p_th, night = tdet.make_scene(prng.PRNGKey(seed), cfg, device="cpu")
    assert tuple(gt.shape) == tuple(p_rgb.shape) == tuple(p_th.shape) == (40, 56)
    assert bool(night) == (night_fraction == 1.0)
    assert set(torch.unique(gt).tolist()) <= {0.0, 1.0}
    # n_obstacles discs of radius 2..5: each covers 13..81 pixels, and they may overlap
    assert 13 <= int(gt.sum()) <= cfg.n_obstacles * 81
    for p in (p_rgb, p_th):
        assert float(p.min()) >= 0.0 and float(p.max()) <= 1.0
        on, off = p[gt > 0], p[gt == 0]
        assert float(on.min()) >= 0.02 and float(on.max()) <= 0.98
        assert float(off.min()) >= 0.05 and float(off.max()) <= 0.11 + 1e-6
    again = tdet.make_scene(prng.PRNGKey(seed), cfg, device="cpu")
    for a, b in zip((gt, p_rgb, p_th), again):
        assert torch.equal(a, b)
    assert again[3] is night


def test_paper_bayes_config_is_the_reference_config():
    for port, ref in ((tcfg.full_config(), jcfg.full_config()),
                      (tcfg.smoke_config(), jcfg.smoke_config())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(tdet.SceneConfig()) == dataclasses.asdict(jdet.SceneConfig())


@pytest.mark.parametrize("seed", [0, 1])
def test_slice_at_smoke_config(seed):
    """The operator path at ``smoke_config()``: per-pixel class maps of every
    frame through fusion_map, the fused decision and the composed one."""
    cfg = tcfg.smoke_config()
    m, k, n_bits = cfg.modalities, cfg.classes, cfg.n_bits
    pixels = cfg.frames_per_batch * cfg.height * cfg.width
    r = np.random.default_rng(seed)
    p = r.dirichlet(np.ones(k), size=(m, pixels)).astype(np.float32)
    jk, tk = _key(seed)
    np.testing.assert_allclose(fusion_map(p, device="cpu").numpy(), np.asarray(jfusion_map(p)),
                               atol=ATOL, rtol=RTOL)
    jdec, jcnt = jbayes_decide(jk, p, n_bits)
    dec, cnt = bayes_decide(tk, p, n_bits, device="cpu")
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))
    composed = pand_popcount(sne_encode(tk, p, n_bits, device="cpu"), device="cpu")
    assert torch.equal(composed, cnt)
    assert torch.equal(torch.argmax(composed, -1).to(torch.int32), dec)


def test_obstacle_fusion_flow_on_a_reference_scene():
    """examples/obstacle_fusion.py on a reference scene: analytic fusion of the
    two modalities, then the stochastic decision on a tile of pixels."""
    cfg = jdet.SceneConfig(height=32, width=32, night_fraction=1.0)
    gt, p_rgb, p_th, _ = jdet.make_scene(jax.random.PRNGKey(0), cfg)
    p_modal = np.stack([np.stack([np.asarray(q), 1 - np.asarray(q)], -1).reshape(-1, 2)
                        for q in (p_rgb, p_th)])
    fused = fusion_map(p_modal, device="cpu")
    np.testing.assert_allclose(fused.numpy(), np.asarray(jfusion_map(p_modal)), atol=ATOL, rtol=RTOL)
    tp, fp, conf = tdet.detection_metrics(torch.from_numpy(np.array(gt)),
                                          fused[:, 0].reshape(gt.shape))
    jtp, jfp, jconf = jdet.detection_metrics(gt, jfusion_map(p_modal)[:, 0].reshape(gt.shape))
    np.testing.assert_allclose([float(tp), float(fp), float(conf)],
                               [float(jtp), float(jfp), float(jconf)], atol=ATOL, rtol=RTOL)
    jk, tk = _key(1)
    tile = p_modal[:, :256]
    jdec, jcnt = jbayes_decide(jk, tile, 256)
    dec, cnt = bayes_decide(tk, tile, 256, device="cpu")
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))


def test_new_modules_import_neither_jax_nor_the_reference():
    mods = ("repro_torch.core.rng", "repro_torch.core.fusion", "repro_torch.configs.paper_bayes",
            "repro_torch.data.detection", "repro_torch.models.bayes_head",
            "repro_torch.kernels.sne_encode.ops", "repro_torch.kernels.sne_encode.kernel",
            "repro_torch.kernels.pand_popcount.ops", "repro_torch.kernels.pand_popcount.kernel",
            "repro_torch.kernels.bayes_decide.ops", "repro_torch.kernels.bayes_decide.kernel",
            "repro_torch.kernels.fusion_map.ops", "repro_torch.kernels.fusion_map.kernel")
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
