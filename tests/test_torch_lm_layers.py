"""``repro_torch.models.layers`` against the live reference
(``repro.models.layers``), function by function, on numpy inputs from a seed.

Tolerances:

* initializers: the reference's draws through the port's ``prng`` (split and
  fold bit-exact, ``normal`` within a few ulp), rounded to bf16: equal except
  at bf16 rounding boundaries -- at most INIT_DIFF_SHARE of the elements
  differ, each by one bf16 ulp;
* masks, cache bookkeeping and ``pad_vocab``: exact;
* norms, RoPE and attention in float32 then cast to bf16: within one bf16 ulp
  (BF16_RTOL) of the reference's value, and no more than a few in a thousand
  elements differ (the float32 reductions sum in another order);
* MLPs and whole attention blocks (bf16 products into a bf16 activation):
  within BLOCK_ATOL + BLOCK_RTOL * |x|.  ``jax.nn.silu`` and ``jax.nn.gelu``
  are jitted as units and keep their intermediates in float32 (XLA's excess
  precision), where torch rounds the activation once; the activations then
  differ by a bf16 ulp in about half the elements.  ``relu2`` and ``none``
  are bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import layers as J
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as L

torch.set_num_threads(1)

BF = ml_dtypes.bfloat16
BF16_RTOL = 2.0 ** -7          # one bf16 ulp, relative
INIT_DIFF_SHARE = 1e-4
BLOCK_ATOL, BLOCK_RTOL = 2e-2, 2e-2
KINDS = ["causal", "local", "chunk", "full_bidir"]


def _t(a):
    """numpy (bf16 through ml_dtypes) -> torch on the CPU."""
    a = np.asarray(a)
    if a.dtype == BF:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _n(t):
    """torch -> float32 numpy (bf16 values exactly)."""
    return t.detach().float().numpy()


def _f(a):
    return np.asarray(a).astype(np.float32)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _bf(r, shape, scale=1.0):
    return (r.standard_normal(shape) * scale).astype(BF)


def _within_ulp(got, want, share=5e-3):
    """Each element within one bf16 ulp, and few of them off at all."""
    got, want = _n(got) if isinstance(got, torch.Tensor) else got, _f(want)
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=1e-30)
    assert np.mean(got != want) <= share


def _kd(k):
    return np.asarray(k, np.uint32)


# --- initializers ---------------------------------------------------------------------

def test_pad_vocab():
    for v in (1, 255, 256, 257, 512, 32064, 92553, 152064, 256206):
        assert L.pad_vocab(v) == J.pad_vocab(v)
        assert L.pad_vocab(v, 128) == J.pad_vocab(v, 128)


@pytest.mark.parametrize("fn,shape", [("dense_init", (64, 96)), ("dense_init", (3072, 512)),
                                      ("embed_init", (512, 64)), ("embed_init", (1000, 300))])
def test_initializers_equal_reference_but_at_bf16_boundaries(fn, shape):
    k = jax.random.PRNGKey(7)
    want = _f(getattr(J, fn)(k, *shape))
    got = _n(getattr(L, fn)(_kd(k), *shape, device="cpu"))
    diff = got != want
    assert diff.mean() <= INIT_DIFF_SHARE
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=0)
    assert getattr(L, fn)(_kd(k), *shape, device="cpu").dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_init(kind):
    want = J.norm_init(48, kind)
    got = L.norm_init(48, kind, device="cpu")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == torch.float32
        np.testing.assert_array_equal(_n(got[name]), np.asarray(want[name]))


@pytest.mark.parametrize("bias", [False, True])
def test_gqa_init_and_mlp_init(bias):
    arch = "qwen2-72b" if bias else "phi3-mini-3.8b"
    cfg = get_smoke_config(arch)
    k = jax.random.PRNGKey(3)
    want = J.gqa_init(k, jsmoke(arch))
    got = L.gqa_init(_kd(k), cfg, device="cpu")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == torch.bfloat16
        assert (_n(got[name]) != _f(want[name])).mean() <= INIT_DIFF_SHARE
    for kind in ("swiglu", "geglu", "gelu", "relu2", "none"):
        w, g = J.mlp_init(k, 64, 128, kind), L.mlp_init(_kd(k), 64, 128, kind, device="cpu")
        assert sorted(g) == sorted(w)
        for name in w:
            assert (_n(g[name]) != _f(w[name])).mean() <= INIT_DIFF_SHARE


def test_meta_initializers_allocate_nothing():
    cfg = get_smoke_config("qwen2-72b")
    p = L.gqa_init(_kd(jax.random.PRNGKey(0)), cfg, device="meta")
    assert all(t.device.type == "meta" for t in p.values())
    assert L.init_kv_cache(2, 8, 2, 16, device="meta")["k"].device.type == "meta"


# --- norms, RoPE, MLPs ----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", [BF, np.float32])
def test_apply_norm(kind, dtype):
    r = _rng(1)
    x = (r.standard_normal((2, 12, 64)) * 3).astype(dtype)
    p = {"scale": r.standard_normal(64).astype(np.float32),
         "bias": r.standard_normal(64).astype(np.float32)}
    want = J.apply_norm(p, jnp.asarray(x), kind)
    got = L.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), kind)
    assert got.dtype == (torch.bfloat16 if dtype == BF else torch.float32)
    if dtype == BF:
        _within_ulp(got, want)
    else:
        np.testing.assert_allclose(_n(got), _f(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("offset", [0, 70_000])          # positions past 2**16
@pytest.mark.parametrize("batched", [False, True])
def test_apply_rope(theta, offset, batched):
    r = _rng(2)
    x = _bf(r, (2, 9, 4, 16))
    pos = (offset + np.arange(9)).astype(np.int32)
    if batched:
        pos = np.stack([pos, pos + 3])
    want = J.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = L.apply_rope(_t(x), torch.from_numpy(pos), theta)
    np.testing.assert_array_equal(_n(L.rope_frequencies(16, theta, device="cpu")),
                                  np.asarray(J.rope_frequencies(16, theta)))
    # float32 sin/cos of angles up to 7e4 rad: the platforms' range reductions
    # agree to about 1e-6 relative, then one bf16 rounding
    np.testing.assert_allclose(_n(got), _f(want), rtol=BF16_RTOL, atol=2.0 ** -8)
    assert np.mean(_n(got) != _f(want)) <= 0.02


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "relu2", "none"])
def test_apply_mlp(kind):
    r = _rng(3)
    x = _bf(r, (2, 12, 64))
    p = {"wi": _bf(r, (64, 128), 0.125), "wg": _bf(r, (64, 128), 0.125),
         "wo": _bf(r, (128, 64), 0.09)}
    want = _f(J.apply_mlp(p, jnp.asarray(x), kind))
    got = _n(L.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), kind))
    if kind in ("relu2", "none"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=BLOCK_ATOL, rtol=BLOCK_RTOL)


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-6, 6, 10001)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(_n(L.gelu(x)), want, atol=2e-6, rtol=0)
    erf = torch.nn.functional.gelu(x)
    assert float((erf - L.gelu(x)).abs().max()) > 1e-4      # the erf form is not it


# --- attention ------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_mask_bias(kind):
    q = np.arange(20, 36, dtype=np.int32)
    k = np.arange(-1, 40, dtype=np.int32)
    want = np.asarray(J._mask_bias(kind, jnp.asarray(q), jnp.asarray(k), 5, 8))
    got = L._mask_bias(kind, torch.from_numpy(q), torch.from_numpy(k), 5, 8)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_n(got), want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("s,q_chunk", [(12, 512), (21, 8)])       # one block; s > q_chunk
@pytest.mark.parametrize("kvh", [1, 2, 4])
def test_multihead_attention(kind, s, q_chunk, kvh):
    r = _rng(4)
    q, k, v = _bf(r, (2, s, 4, 16)), _bf(r, (2, s, kvh, 16)), _bf(r, (2, s, kvh, 16))
    pos = np.arange(s, dtype=np.int32) + 3
    kw = dict(kind=kind, window=5, chunk=8, q_chunk=q_chunk)
    want = J.multihead_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 q_positions=jnp.asarray(pos), k_positions=jnp.asarray(pos), **kw)
    got = L.multihead_attention(_t(q), _t(k), _t(v), q_positions=torch.from_numpy(pos),
                                k_positions=torch.from_numpy(pos), **kw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    _within_ulp(got, want, share=0.01)


def test_fully_masked_row_gives_zeros():
    r = _rng(5)
    q, k, v = _bf(r, (1, 1, 4, 16)), _bf(r, (1, 6, 2, 16)), _bf(r, (1, 6, 2, 16))
    kpos = np.full(6, -1, np.int32)                  # an empty cache: every slot invalid
    qpos = np.zeros(1, np.int32)
    args = dict(q_positions=qpos, k_positions=kpos, k_valid=kpos >= 0)
    want = J.multihead_attention(*map(jnp.asarray, (q, k, v)),
                                 **{n: jnp.asarray(a) for n, a in args.items()})
    got = L.multihead_attention(_t(q), _t(k), _t(v),
                                **{n: torch.from_numpy(a) for n, a in args.items()})
    assert not np.isnan(_f(want)).any() and not np.isnan(_n(got)).any()
    np.testing.assert_array_equal(_n(got), np.zeros((1, 1, 4, 16), np.float32))
    np.testing.assert_array_equal(_n(got), _f(want))


@pytest.mark.parametrize("kind", ["causal", "local", "chunk"])
def test_cache_len_and_init_kv_cache(kind):
    for seq in (4, 16, 64):
        assert L.cache_len_for_kind(kind, seq, 16, 8) == J.cache_len_for_kind(kind, seq, 16, 8)
        assert L.cache_len_for_kind(kind, seq, 0, 0) == J.cache_len_for_kind(kind, seq, 0, 0)
    want = J.init_kv_cache(2, 8, 2, 16)
    got = L.init_kv_cache(2, 8, 2, 16, device="cpu")
    for name in want:
        assert tuple(got[name].shape) == want[name].shape
        np.testing.assert_array_equal(_n(got[name]), _f(want[name]))
    assert got["k"].dtype == torch.bfloat16 and got["pos"].dtype == torch.int32


def _block_params(cfg, seed=6):
    r = _rng(seed)
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    p = {"wq": _bf(r, (d, h * hd), d ** -0.5), "wk": _bf(r, (d, kv * hd), d ** -0.5),
         "wv": _bf(r, (d, kv * hd), d ** -0.5), "wo": _bf(r, (h * hd, d), (h * hd) ** -0.5)}
    if cfg.qkv_bias:
        p.update(bq=_bf(r, (h * hd,), 0.1), bk=_bf(r, (kv * hd,), 0.1), bv=_bf(r, (kv * hd,), 0.1))
    return p


def _cache_close(got, want):
    for name in ("k", "v"):
        _within_ulp(got[name], want[name], share=0.01)
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))


@pytest.mark.parametrize("arch", ["qwen2-72b", "phi3-mini-3.8b"])
@pytest.mark.parametrize("s,t_cache", [(6, 16), (16, 16), (20, 8)])   # s < t, s == t, s > t
@pytest.mark.parametrize("rope", [True, False])
def test_gqa_apply_prefill(arch, s, t_cache, rope):
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    p = _block_params(cfg)
    x = _bf(_rng(7), (2, s, cfg.d_model))
    pos = np.arange(s, dtype=np.int32)
    jc = J.init_kv_cache(2, t_cache, cfg.num_kv_heads, cfg.resolved_head_dim)
    want, wc = J.gqa_apply(p, jnp.asarray(x), jcfg, kind="causal", positions=jnp.asarray(pos),
                           rope=rope, cache=jc, cache_pos=jnp.int32(0))
    tc = L.init_kv_cache(2, t_cache, cfg.num_kv_heads, cfg.resolved_head_dim, device="cpu")
    got, gc = L.gqa_apply({k: _t(v) for k, v in p.items()}, _t(x), cfg, kind="causal",
                          positions=torch.from_numpy(pos), rope=rope, cache=tc, cache_pos=0)
    np.testing.assert_allclose(_n(got), _f(want), atol=BLOCK_ATOL, rtol=BLOCK_RTOL)
    _cache_close(gc, wc)
    assert int(tc["pos"].max()) == -1                # the cache given is not changed
    nocache, none = L.gqa_apply({k: _t(v) for k, v in p.items()}, _t(x), cfg, kind="causal",
                                positions=torch.from_numpy(pos), rope=rope)
    assert none is None and torch.equal(nocache, got)


@pytest.mark.parametrize("kind", ["causal", "local", "chunk"])
def test_gqa_apply_decode_rolls_past_t_cache(kind):
    """Prefill 5 tokens into 8 slots, then decode 9 more: the write slot wraps
    at pos % 8, overwritten slots carry their new positions."""
    cfg, jcfg = get_smoke_config("qwen2-72b"), jsmoke("qwen2-72b")
    cfg = dataclasses.replace(cfg, window=6, chunk=4)
    jcfg = dataclasses.replace(jcfg, window=6, chunk=4)
    p = _block_params(cfg, seed=8)
    tp = {k: _t(v) for k, v in p.items()}
    r = _rng(9)
    x = _bf(r, (2, 5, cfg.d_model))
    pos = np.arange(5, dtype=np.int32)
    jc = J.init_kv_cache(2, 8, cfg.num_kv_heads, cfg.resolved_head_dim)
    _, jc = J.gqa_apply(p, jnp.asarray(x), jcfg, kind=kind, positions=jnp.asarray(pos), cache=jc,
                        cache_pos=jnp.int32(0))
    tc = L.init_kv_cache(2, 8, cfg.num_kv_heads, cfg.resolved_head_dim, device="cpu")
    _, tc = L.gqa_apply(tp, _t(x), cfg, kind=kind, positions=torch.from_numpy(pos), cache=tc,
                        cache_pos=0)
    for t in range(5, 14):
        xt = _bf(r, (2, 1, cfg.d_model))
        pt = np.array([t], np.int32)
        want, jc = J.gqa_apply(p, jnp.asarray(xt), jcfg, kind=kind, positions=jnp.asarray(pt),
                               cache=jc, cache_pos=jnp.int32(t))
        got, tc = L.gqa_apply(tp, _t(xt), cfg, kind=kind, positions=torch.from_numpy(pt),
                              cache=tc, cache_pos=t)
        np.testing.assert_allclose(_n(got), _f(want), atol=BLOCK_ATOL, rtol=BLOCK_RTOL)
        _cache_close(tc, jc)
    assert sorted(tc["pos"].tolist()) == list(range(6, 14))


def test_cross_attention():
    cfg, jcfg = get_smoke_config("seamless-m4t-large-v2"), jsmoke("seamless-m4t-large-v2")
    k = jax.random.PRNGKey(11)
    jp = J.cross_attention_init(k, jcfg)
    tp = L.cross_attention_init(_kd(k), cfg, device="cpu")
    assert sorted(tp) == sorted(jp)
    p = {n: np.asarray(v) for n, v in jp.items()}
    r = _rng(12)
    x, enc = _bf(r, (2, 7, cfg.d_model)), _bf(r, (2, 5, cfg.d_model))
    want, wc = J.cross_attention_apply(p, jnp.asarray(x), jnp.asarray(enc), jcfg)
    tpp = {n: _t(v) for n, v in p.items()}
    got, gc = L.cross_attention_apply(tpp, _t(x), _t(enc), cfg)
    np.testing.assert_allclose(_n(got), _f(want), atol=BLOCK_ATOL, rtol=BLOCK_RTOL)
    for name in ("k", "v"):
        _within_ulp(gc[name], wc[name])
    again, _ = L.cross_attention_apply(tpp, _t(x), None, cfg, cache=gc)   # keys from the cache
    assert torch.equal(again, got)
