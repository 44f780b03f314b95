"""The port's block modules (``repro_torch.models.{moe,mla,rglru,xlstm,encdec}``)
against the live reference on the same numpy-made inputs, and the mirrors of
the reference's own block tests.

Tolerances:

* float32 weights and inputs (``F32``): within atol 1e-5, rtol 1e-4.  The
  functions run the reference's formulas op for op; what is left is the
  order of float32 sums (matmuls, einsums -- the reference's three-operand
  einsums contract in an order of XLA's choosing -- and softmax) and the
  platforms' ``exp``/``log1p``/``tanh``, a few ulp each;
* bf16 weights (the models' own dtype, ``BF``): within atol 2e-2, rtol 2e-2
  of the compiled reference and a relative Frobenius error under 3e-2.  XLA
  keeps bf16 intermediates of a fused expression in float32 (inside
  ``jax.nn.silu``/``gelu``, the conv taps, the MoE combine's products)
  where the port rounds each op as the code reads, and such a rounding
  difference moves a later bf16 rounding by an ulp; sLSTM's ``(x + m) - x``
  returns ``m`` only to within an ulp of ``x``;
* bit for bit: the associative scan against ``lax.associative_scan`` run op
  by op (eager ``jnp`` contracts nothing); the MoE combine against the
  reference's bf16 ``.at[].add`` (which rounds after each add, compiled or
  not); the router's top-k order on exact ties; ``lambda_raw``'s uniform
  draw (the reference's compiled draw is one FMA); the capacity and the
  dropped assignments;
* the reference's own mirrors keep the reference's bounds (dispatch
  equivalence 1e-4, chunked mLSTM and the RG-LRU scan against their decode
  loops 2e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import api as japi
from repro.models import encdec as jencdec
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro.models import xlstm as jxlstm
from repro_torch.configs import get_smoke_config
from repro_torch.models import api, bayes_head, convert, encdec, layers, mla, moe, rglru, \
    transformer, xlstm

torch.set_num_threads(1)

F32 = dict(atol=1e-5, rtol=1e-4)
BF = dict(atol=2e-2, rtol=2e-2)
BF_REL = 3e-2
LOGITS = dict(atol=1e-1, rtol=2e-2)     # tests/test_torch_lm_models.py's logit bounds
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _kd(k):
    return np.asarray(k, np.uint32)


def _params(jparams):
    """The reference's params (a dict of jax arrays) -> the same as torch (CPU)."""
    return convert._tree(jax.tree.map(np.asarray, jparams), None, "cpu")


def _x(shape, dtype, seed=0, scale=0.5):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x).astype(JDT[dtype]), torch.from_numpy(x).to(dtype)


def _jit(fn, cfg):
    """The reference function compiled, with its config closed over (one
    compile per shape instead of one per eager op)."""
    return jax.jit(lambda p, x, *rest, **kw: fn(p, x, cfg, *rest, **kw))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t).astype(np.float32)


def _close(got, want, dtype, tol=None):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **(tol or (F32 if dtype == torch.float32 else BF)))
    if dtype == torch.bfloat16:
        assert np.linalg.norm(got - want) <= BF_REL * np.linalg.norm(want)


def _logits_close(got, want):
    _close(got, want, torch.bfloat16, LOGITS)


DTYPES = [torch.float32, torch.bfloat16]


# --------------------------------------------------------------------------- moe

def _moe_cfg(mod, arch, **kw):
    cfg = mod(arch)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("impl", ["masked", "dense"])
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "deepseek-v3-671b"])
def test_moe_matches_reference(arch, impl, dtype):
    """Routing first (ids equal), then the outputs and the aux loss."""
    cfg, jcfg = _moe_cfg(get_smoke_config, arch, impl=impl), _moe_cfg(jsmoke, arch, impl=impl)
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg, dtype=JDT[dtype])
    xj, xt = _x((2, 8, cfg.d_model), dtype)
    seen = []
    real = moe._router_probs

    def record(logits, kind, k):
        out = real(logits, kind, k)
        seen.append(out[1])
        return out
    want, waux = _jit(jmoe.moe_apply, jcfg)(jp, xj)
    jlogits = xj.reshape(16, -1).astype(jnp.float32) @ jp["router"]
    _, wids = jmoe._router_probs(jlogits, jcfg.moe.router, jcfg.moe.top_k)
    moe._router_probs = record
    try:
        got, aux = moe.moe_apply(_params(jp), xt, cfg)
    finally:
        moe._router_probs = real
    np.testing.assert_array_equal(seen[0].numpy(), np.asarray(wids))
    _close(got, want, dtype)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)


def test_router_top_k_takes_ties_in_index_order():
    """Exact ties in the scores: ``lax.top_k``'s order, the lower index first."""
    logits = np.zeros((6, 8), np.float32)
    logits[1, [2, 5, 7]] = 1.0
    logits[2] = [0.5, 2.0, 0.5, 2.0, 0.5, 2.0, 0.5, 2.0]
    logits[3, ::2] = -1.0
    logits[4] = np.linspace(0, 1, 8)[::-1]
    logits[5, [0, 7]] = 3.0
    for kind in ("softmax", "sigmoid"):
        for k in (1, 2, 3, 8):
            wv, wi = jmoe._router_probs(jnp.asarray(logits), kind, k)
            gv, gi = moe._router_probs(torch.from_numpy(logits), kind, k)
            np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
            np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-6)


def test_moe_capacity_drops_match_reference():
    """At a small capacity_factor the sort dispatch drops assignments: the
    same capacity, the same dropped (token, expert) slots as the reference."""
    cfg = _moe_cfg(get_smoke_config, "deepseek-v3-671b", capacity_factor=0.25)
    jcfg = _moe_cfg(jsmoke, "deepseek-v3-671b", capacity_factor=0.25)
    jp = jmoe.moe_init(jax.random.PRNGKey(3), jcfg, dtype=jnp.float32)
    # 2 x 100 tokens x top-2 = 400 assignments over 4 experts: cap = int(0.25*2*200/4)
    # = 25, floored to min(400, 64) = 64, so at least 144 of 400 are dropped
    xj, xt = _x((2, 100, cfg.d_model), torch.float32, seed=4)
    want, _ = _jit(jmoe.moe_apply, jcfg)(jp, xj)
    got, _ = moe.moe_apply(_params(jp), xt, cfg)
    _close(got, want, torch.float32)
    # the dropped assignments are there: the output is not the dropless one
    free = _moe_cfg(get_smoke_config, "deepseek-v3-671b", capacity_factor=8.0)
    dropless, _ = moe.moe_apply(_params(jp), xt, free)
    assert not torch.allclose(got, dropless, atol=1e-3)


@pytest.mark.parametrize("k", [1, 2, 8])
def test_moe_combine_adds_in_the_references_order(k):
    """The combine of each token's k weighted expert outputs, bf16, against
    the reference's ``zeros.at[stok].add(gathered)`` (jitted): bit for bit."""
    t, d = 24, 32
    r = np.random.default_rng(k)
    ids = np.stack([r.permutation(16)[:k] for _ in range(t)]).reshape(-1)
    order = np.argsort(ids, kind="stable")
    stok = np.repeat(np.arange(t), k)[order]
    g = r.standard_normal((t * k, d)).astype(np.float32) * np.exp(r.normal(0, 3, (t * k, 1)))
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    want = jax.jit(lambda g, s: jnp.zeros((t, d), jnp.bfloat16).at[s].add(g))(gb, jnp.asarray(stok))
    gathered = torch.from_numpy(g).bfloat16()
    got = moe._combine(lambda j: gathered[j], torch.from_numpy(order), t, k)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


def test_moe_dispatch_equivalence():
    """Mirror of the reference's test: the sort dispatch equals the dense
    all-experts einsum at a no-drop capacity (float32, 1e-4)."""
    cfg = _moe_cfg(get_smoke_config, "llama4-scout-17b-a16e", capacity_factor=8.0)
    params = moe.moe_init(_kd(jax.random.PRNGKey(0)), cfg, dtype=torch.float32, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 8, cfg.d_model))
                         .astype(np.float32))
    out_sort, _ = moe.moe_apply(params, x, cfg)
    out_dense, _ = moe.moe_apply(params, x, dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, impl="dense")))
    np.testing.assert_allclose(out_sort.numpy(), out_dense.numpy(), atol=1e-4, rtol=1e-4)


def test_moe_init_equals_reference():
    """bf16 expert stacks equal but at bf16 boundaries; the float32 router
    within 4 ulp (``prng.normal`` against ``jax.random.normal``)."""
    cfg, jcfg = get_smoke_config("deepseek-v3-671b"), jsmoke("deepseek-v3-671b")
    want = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(5), jcfg))
    got = moe.moe_init(_kd(jax.random.PRNGKey(5)), cfg, device="cpu")
    for name in ("wi", "wg", "wo"):
        assert got[name].shape == want[name].shape and got[name].dtype == torch.bfloat16
        assert np.mean(_np(got[name]) != want[name].astype(np.float32)) <= 1e-3
    assert got["router"].dtype == torch.float32
    np.testing.assert_allclose(got["router"].numpy(), want["router"], rtol=4 * 2.0 ** -23, atol=0)
    meta = moe.moe_init(_kd(jax.random.PRNGKey(5)), cfg, device="meta")
    assert meta["wi"].device.type == "meta" and tuple(meta["wi"].shape) == want["wi"].shape


def test_moe_under_a_mesh_raises_naming_the_multi_device_item(monkeypatch):
    """Under a mesh with no `model` axis the layer takes the local path, as
    the reference's does (the expert-parallel path is held on gloo worlds in
    ``test_torch_dist_models.py``)."""
    from repro_torch.distributed import context, sharding
    cfg = get_smoke_config("llama4-scout-17b-a16e")
    params = moe.moe_init(_kd(jax.random.PRNGKey(0)), cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 2, cfg.d_model))
                         .astype(np.float32)).to(torch.bfloat16)
    want, want_aux = moe.moe_apply(params, x, cfg)
    monkeypatch.setattr(context, "current_mesh", lambda: sharding.MeshShape((2,), ("frames",)))
    got, aux = moe.moe_apply(params, x, cfg)
    assert torch.equal(got, want) and torch.equal(aux, want_aux)


# --------------------------------------------------------------------------- mla

@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_prefill_cache_and_absorbed_decode_match_reference(dtype):
    """No cache; a prefill that fills the cache; absorbed decode steps; a
    prefill against a cache already holding positions (expanded latents)."""
    cfg, jcfg = get_smoke_config("deepseek-v3-671b"), jsmoke("deepseek-v3-671b")
    jp = jmla.mla_init(jax.random.PRNGKey(0), jcfg, dtype=JDT[dtype])
    tp = _params(jp)
    xj, xt = _x((2, 9, cfg.d_model), dtype)
    pos = jnp.arange(6)
    ref = _jit(jmla.mla_apply, jcfg)
    want, _ = ref(jp, xj[:, :6], positions=pos)
    got, _ = mla.mla_apply(tp, xt[:, :6], cfg, positions=torch.arange(6))
    _close(got, want, dtype)
    jc = jmla.mla_init_cache(2, 12, jcfg, dtype=JDT[dtype])
    tc = mla.mla_init_cache(2, 12, cfg, dtype, device="cpu")
    want, jc = ref(jp, xj[:, :6], positions=pos, cache=jc, cache_pos=jnp.int32(0))
    got, tc = mla.mla_apply(tp, xt[:, :6], cfg, positions=torch.arange(6), cache=tc, cache_pos=0)
    _close(got, want, dtype)
    for t in (6, 7):
        want, jc = ref(jp, xj[:, t:t + 1], positions=jnp.full((1,), t), cache=jc,
                       cache_pos=jnp.int32(t))
        got, tc = mla.mla_apply(tp, xt[:, t:t + 1], cfg, positions=torch.full((1,), t),
                                cache=tc, cache_pos=t)
        _close(got, want, dtype)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        _close(tc["latent"], jc["latent"], torch.bfloat16)
    # a multi-token call against the filled cache expands the cached latents
    want, jc = ref(jp, xj[:, 8:9].repeat(2, 1), positions=jnp.arange(8, 10), cache=jc,
                   cache_pos=jnp.int32(8))
    got, tc = mla.mla_apply(tp, xt[:, 8:9].repeat(1, 2, 1), cfg, positions=torch.arange(8, 10),
                            cache=tc, cache_pos=8)
    _close(got, want, dtype)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_mla_cache_write_clamps_like_dynamic_update_slice():
    """A write whose slot would run past the end starts where it fits."""
    cfg, jcfg = get_smoke_config("deepseek-v3-671b"), jsmoke("deepseek-v3-671b")
    jp = jmla.mla_init(jax.random.PRNGKey(1), jcfg, dtype=jnp.float32)
    xj, xt = _x((1, 3, cfg.d_model), torch.float32)
    jc = jmla.mla_init_cache(1, 8, jcfg, dtype=jnp.float32)
    _, jc = _jit(jmla.mla_apply, jcfg)(jp, xj, positions=jnp.arange(6, 9), cache=jc,
                                       cache_pos=jnp.int32(6))
    _, tc = mla.mla_apply(_params(jp), xt, cfg, positions=torch.arange(6, 9),
                          cache=mla.mla_init_cache(1, 8, cfg, torch.float32, device="cpu"),
                          cache_pos=6)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert tc["pos"].tolist() == [-1] * 5 + [6, 7, 8]


# --------------------------------------------------------------------------- rglru

def test_associative_scan_equals_lax_associative_scan_bit_for_bit():
    """The odd/even recursion of ``lax.associative_scan``, run op by op, on
    the RG-LRU combine, float32: lengths that take each branch (even and odd
    at each level of the recursion)."""
    def jcombine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]
    r = np.random.default_rng(7)
    for s in (1, 2, 3, 4, 5, 6, 7, 11, 61):
        a = r.uniform(0.5, 1.0, (2, s, 5)).astype(np.float32)
        u = r.standard_normal((2, s, 5)).astype(np.float32)
        wa, wh = jax.lax.associative_scan(jcombine, (jnp.asarray(a), jnp.asarray(u)), axis=1)
        ga, gh = rglru.associative_scan(rglru._combine, [torch.from_numpy(a), torch.from_numpy(u)],
                                        axis=1)
        np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
        np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))


def test_softplus_and_log_sigmoid_follow_jax():
    """``logaddexp(x, 0)`` and ``-softplus(-x)``, past torch's threshold of 20."""
    x = np.concatenate([np.linspace(-40, 40, 2001), [-1e4, 1e4, 0.0]]).astype(np.float32)
    for mine, theirs in ((rglru.softplus, jax.nn.softplus), (xlstm.log_sigmoid, jax.nn.log_sigmoid)):
        np.testing.assert_allclose(mine(torch.from_numpy(x)).numpy(), np.asarray(theirs(x)),
                                   rtol=2 * 2.0 ** -23, atol=1e-30)


def test_rglru_init_equals_reference():
    cfg, jcfg = get_smoke_config("recurrentgemma-2b"), jsmoke("recurrentgemma-2b")
    want = jax.tree.map(np.asarray, jrglru.rglru_init(jax.random.PRNGKey(2), jcfg))
    got = rglru.rglru_init(_kd(jax.random.PRNGKey(2)), cfg, device="cpu")
    assert got["lambda_raw"].dtype == torch.float32
    np.testing.assert_array_equal(got["lambda_raw"].numpy(), want["lambda_raw"])
    for name in ("wx", "wy", "conv", "w_input_gate", "w_rec_gate", "wo"):
        assert got[name].dtype == torch.bfloat16 and tuple(got[name].shape) == want[name].shape
        assert np.mean(_np(got[name]) != want[name].astype(np.float32)) <= 1e-3, name


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_scan_and_step_match_reference(dtype):
    """The scan over a prompt (from no state and from a state), then decode
    steps, with the conv and h states."""
    cfg, jcfg = get_smoke_config("recurrentgemma-2b"), jsmoke("recurrentgemma-2b")
    jp = jrglru.rglru_init(jax.random.PRNGKey(0), jcfg, dtype=JDT[dtype])
    tp = _params(jp)
    xj, xt = _x((2, 14, cfg.d_model), dtype)
    ref = _jit(jrglru.rglru_apply, jcfg)
    want, js = ref(jp, xj[:, :9])
    got, ts = rglru.rglru_apply(tp, xt[:, :9], cfg)
    _close(got, want, dtype)
    _close(ts["h"], js["h"], dtype)
    assert ts["h"].dtype == torch.float32 and ts["conv"].dtype == dtype
    np.testing.assert_array_equal(_np(ts["conv"]), _np(js["conv"]))
    for t in range(9, 12):
        want, js = ref(jp, xj[:, t:t + 1], js)
        got, ts = rglru.rglru_apply(tp, xt[:, t:t + 1], cfg, ts)
        _close(got, want, dtype)
        _close(ts["h"], js["h"], dtype)
    want, js = ref(jp, xj[:, 12:], js)
    got, ts = rglru.rglru_apply(tp, xt[:, 12:], cfg, ts)
    _close(got, want, dtype)


def test_rglru_scan_matches_decode_loop():
    """Mirror of the reference's test (float32 weights, 2e-3)."""
    cfg = get_smoke_config("recurrentgemma-2b")
    params = rglru.rglru_init(_kd(jax.random.PRNGKey(0)), cfg, dtype=torch.float32, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 12, cfg.d_model))
                         .astype(np.float32) * 0.5)
    out_par, _ = rglru.rglru_apply(params, x, cfg, None)
    state = rglru.rglru_init_state(2, cfg, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(12):
        o, state = rglru.rglru_apply(params, x[:, t:t + 1], cfg, state)
        outs.append(o)
    np.testing.assert_allclose(out_par.numpy(), torch.cat(outs, 1).numpy(), atol=2e-3, rtol=2e-3)


# --------------------------------------------------------------------------- xlstm

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chunk", [256, 8])
def test_mlstm_matches_reference(chunk, dtype):
    """The chunked prompt (one chunk, or 8-token chunks with padding), then
    exact decode steps; states C, n, m."""
    cfg = dataclasses.replace(get_smoke_config("xlstm-350m"), mlstm_chunk=chunk)
    jcfg = dataclasses.replace(jsmoke("xlstm-350m"), mlstm_chunk=chunk)
    jp = jxlstm.mlstm_init(jax.random.PRNGKey(0), jcfg, dtype=JDT[dtype])
    tp = _params(jp)
    xj, xt = _x((2, 22, cfg.d_model), dtype)
    ref = _jit(jxlstm.mlstm_apply, jcfg)
    want, js = ref(jp, xj[:, :20])
    got, ts = xlstm.mlstm_apply(tp, xt[:, :20], cfg)
    _close(got, want, dtype)
    for name in ("C", "n", "m"):
        _close(ts[name], js[name], dtype)
    for t in (20, 21):
        want, js = ref(jp, xj[:, t:t + 1], js)
        got, ts = xlstm.mlstm_apply(tp, xt[:, t:t + 1], cfg, ts)
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_matches_reference(dtype):
    cfg, jcfg = get_smoke_config("xlstm-350m"), jsmoke("xlstm-350m")
    jp = jxlstm.slstm_init(jax.random.PRNGKey(1), jcfg, dtype=JDT[dtype])
    tp = _params(jp)
    xj, xt = _x((2, 13, cfg.d_model), dtype)
    ref = _jit(jxlstm.slstm_apply, jcfg)
    want, js = ref(jp, xj[:, :12])
    got, ts = xlstm.slstm_apply(tp, xt[:, :12], cfg)
    _close(got, want, dtype)
    want, js = ref(jp, xj[:, 12:], js)
    got, ts = xlstm.slstm_apply(tp, xt[:, 12:], cfg, ts)
    _close(got, want, dtype)
    for name in ("c", "n", "m", "h"):
        _close(ts[name], js[name], torch.float32 if dtype == torch.float32 else dtype)


def test_xlstm_inits_equal_reference():
    """bf16 leaves but at bf16 boundaries, the float32 gates within 4 ulp."""
    cfg, jcfg = get_smoke_config("xlstm-350m"), jsmoke("xlstm-350m")
    for jinit, init in ((jxlstm.mlstm_init, xlstm.mlstm_init), (jxlstm.slstm_init, xlstm.slstm_init)):
        want = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(4), jcfg))
        got = init(_kd(jax.random.PRNGKey(4)), cfg, device="cpu")
        for name in ("w_i", "w_f"):
            assert got[name].dtype == torch.float32
            np.testing.assert_allclose(got[name].numpy(), want[name], rtol=4 * 2.0 ** -23, atol=0)
        assert all(np.mean(_np(got[n]) != want[n].astype(np.float32)) <= 1e-3
                   for n in want if n not in ("w_i", "w_f", "ffn"))


def test_mlstm_chunked_matches_decode_loop():
    """Mirror of the reference's test (float32 weights, 2e-3)."""
    cfg = get_smoke_config("xlstm-350m")
    params = xlstm.mlstm_init(_kd(jax.random.PRNGKey(0)), cfg, dtype=torch.float32, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 20, cfg.d_model))
                         .astype(np.float32) * 0.5)
    out_par, state_par = xlstm.mlstm_apply(params, x, cfg)
    state = xlstm.mlstm_init_state(2, cfg, device="cpu")
    outs = []
    for t in range(20):
        o, state = xlstm.mlstm_apply(params, x[:, t:t + 1], cfg, state)
        outs.append(o)
    np.testing.assert_allclose(out_par.numpy(), torch.cat(outs, 1).numpy(), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(state_par["C"].numpy(), state["C"].numpy(), atol=2e-3, rtol=2e-3)


# --------------------------------------------------------------------------- encdec

def test_encdec_encode_prefill_and_decode_match_reference():
    """Encoder output, teacher-forced logits, the prefill's self caches and
    cross k/v (one per decoder layer here, stacked there), decode steps."""
    arch = "seamless-m4t-large-v2"
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    ref = jax.tree.map(np.asarray, japi.init(jcfg, jax.random.PRNGKey(0)))
    model = convert.params_from_reference(ref, cfg, device="cpu")
    assert isinstance(model, encdec.Model)
    r = np.random.default_rng(2)
    frames = r.standard_normal((2, 4, cfg.d_model)).astype(np.float32)
    toks = r.integers(0, cfg.vocab_size, (2, 9))
    jf, jt = jnp.asarray(frames), jnp.asarray(toks)
    tf, tt = torch.from_numpy(frames), torch.from_numpy(toks)
    with torch.no_grad():
        _close(encdec.encode(model, cfg, tf), jax.jit(lambda p, f: jencdec.encode(p, jcfg, f))(ref, jf), torch.bfloat16)
        got, aux = model(tf, tt)
        assert float(aux) == 0.0
        _logits_close(got, jax.jit(lambda p, f, t: jencdec.forward(p, jcfg, f, t))(ref, jf, jt)[0])
        gl, gs = encdec.prefill(model, cfg, tf, tt[:, :6], 12)
    wl, ws = jax.jit(lambda p, f, t: jencdec.prefill(p, jcfg, f, t, 12))(ref, jf, jt[:, :6])
    decode = jax.jit(lambda p, t, s, pos: jencdec.decode_step(p, jcfg, t, s, pos))
    _logits_close(gl, wl)
    assert len(gs["self"]) == len(gs["cross"]) == cfg.dec_layers
    for layer in range(cfg.dec_layers):
        np.testing.assert_array_equal(gs["self"][layer]["pos"].numpy(),
                                      np.asarray(ws["self"]["pos"][layer]))
        assert tuple(gs["cross"][layer]["k"].shape) == ws["cross"]["k"].shape[1:]
        _close(gs["cross"][layer]["v"], ws["cross"]["v"][layer], torch.bfloat16)
    for t in (6, 7, 8):
        wl, ws = decode(ref, jt[:, t], ws, jnp.int32(t))
        with torch.no_grad():
            gl, gs = encdec.decode_step(model, cfg, tt[:, t], gs, t)
        _logits_close(gl, wl)


def test_encdec_init_equals_reference():
    arch = "seamless-m4t-large-v2"
    want = jax.tree.map(np.asarray, japi.init(jsmoke(arch), jax.random.PRNGKey(1)))
    model = api.init(get_smoke_config(arch), _kd(jax.random.PRNGKey(1)), device="cpu")
    got = dict(model.named_parameters())
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        ks = jax.tree_util.keystr(path)
        stacked = ks.startswith("['enc_blocks']") or ks.startswith("['dec_blocks']")
        for r in range(leaf.shape[0]) if stacked else [None]:
            w = (leaf[r] if stacked else leaf).astype(np.float32)
            mine = _np(got[convert.state_dict_key(ks, r)])
            assert mine.shape == w.shape and np.mean(mine != w) <= 1e-3, ks


# --------------------------------------------------------------------------- mtp

def _mtp_sources(mod_api, mod_tr, mod_layers, params, cfg, tokens, xp):
    """test_mtp_fusion's two posteriors of the final token: the main head at
    position -2, the MTP head from position -3 and the embedding of -2."""
    h, _ = mod_tr.forward(params, cfg, tokens, return_hidden=True)
    unembed = params["unembed"]
    main = xp.astype(h[:, -2] @ unembed, xp.float32)
    emb_next = params["embed"][tokens[:, -2]]
    h2 = (xp.concatenate([h[:, -3], emb_next], axis=-1) @ params["mtp"]["proj"])[:, None, :]
    h2, _, _ = mod_tr.block_apply(params["mtp"]["block"], h2, cfg, cfg.pattern[0],
                                  positions=xp.arange(1))
    h2 = mod_layers.apply_norm(params["mtp"]["norm"], h2, cfg.norm)
    return main, xp.astype(h2[:, 0] @ unembed, xp.float32)


class _JaxNp:
    float32 = jnp.float32
    concatenate = staticmethod(jnp.concatenate)
    arange = staticmethod(jnp.arange)

    @staticmethod
    def astype(x, dtype):
        return x.astype(dtype)


class _TorchNp:
    """The few array functions ``_mtp_sources`` takes, for torch tensors."""
    float32 = torch.float32

    @staticmethod
    def astype(x, dtype):
        return x.to(dtype)

    @staticmethod
    def concatenate(xs, axis):
        return torch.cat(xs, dim=axis)

    @staticmethod
    def arange(n):
        return torch.arange(n)


def test_mtp_head_as_second_posterior_source():
    """Mirror of tests/serve/test_mtp_fusion.py against the port, and the two
    sources against the reference's: the fused decision, analytic and
    through the stochastic gate's ``bayes_decide`` (plain version here)."""
    arch = "deepseek-v3-671b"
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    ref = jax.tree.map(np.asarray, japi.init(jcfg, jax.random.PRNGKey(0)))
    params = convert.params_from_reference(ref, cfg, device="cpu")
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0, cfg.vocab_size))
    from repro.models import layers as jlayers
    from repro.models import transformer as jtransformer
    wmain, wmtp = jax.jit(lambda p, t: _mtp_sources(japi, jtransformer, jlayers, p, jcfg, t,
                                                     _JaxNp))(ref, jnp.asarray(tokens))
    with torch.no_grad():
        main, mtp = _mtp_sources(api, transformer, layers, params, cfg,
                                 torch.from_numpy(tokens.astype(np.int64)), _TorchNp)
    for g, w in ((main, wmain), (mtp, wmtp)):
        _logits_close(g, w)
    sources = torch.stack([main, mtp])
    token, conf, fused = bayes_head.fuse_posteriors(sources, top_k=8, device="cpu")
    assert token.shape == (2,)
    assert bool(((conf >= 0) & (conf <= 1)).all())
    np.testing.assert_allclose(fused.sum(-1).numpy(), 1.0, rtol=1e-5)
    ok, _ = bayes_head.reliable_decision(token, conf, threshold=0.2)
    assert ok.shape == (2,)
    stoken, sconf = bayes_head.fuse_posteriors_stochastic(_kd(jax.random.PRNGKey(2)), sources,
                                                          top_k=8, n_bits=256, device="cpu")
    assert stoken.shape == (2,) and bool(((sconf >= 0) & (sconf <= 1)).all())
    # the MTP term of the loss (held against the reference's in test_torch_lm_models.py)
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int64)),
             "labels": torch.from_numpy(np.roll(tokens, -1, 1).astype(np.int64))}
    with torch.no_grad():
        loss, metrics = api.loss(params, cfg, batch)
    assert sorted(metrics) == ["aux", "mtp_nll", "nll"]
    assert float(loss) == pytest.approx(float(metrics["nll"]) + 0.3 * float(metrics["mtp_nll"])
                                        + 0.01 * float(metrics["aux"]), rel=1e-6)
