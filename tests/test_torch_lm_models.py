"""The port's decoder stack (``repro_torch.models.{transformer,api,convert}``)
against the live reference at the smoke configs of the slice's five archs,
with the reference's own weights carried across by ``convert``.

Tolerances:

* logits of ``forward``, ``prefill`` and ``decode``: within LOGIT_ATOL +
  LOGIT_RTOL * |x|, and the relative Frobenius error under LOGIT_REL.  The
  reference runs compiled, and XLA keeps some bf16 intermediates in float32
  (the residual stream into a norm, the activations inside ``jax.nn.silu`` /
  ``gelu``) where the port rounds each op as the code is written; a 2-layer
  smoke model then differs by a few bf16 ulp of its logits.  Run op by op
  (``jax.disable_jit``) the reference rounds as the port does, and the arch
  whose MLP has no such activation (minitron, relu2) is bit for bit but where
  a float32 reduction, summed in another order, flips a bf16 rounding: at
  most OP_BY_OP_SHARE of the logits differ, each by one bf16 ulp;
* the loss: within LOSS_ATOL;
* the port's own ``init`` from the same key: equal to the reference's except
  at bf16 rounding boundaries (``prng.normal`` is within a few ulp of
  ``jax.random.normal``): at most INIT_DIFF_SHARE of a leaf's elements differ;
* ``convert`` both ways: leaf for leaf, bit for bit.
"""

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import api as japi
from repro.models import transformer as jtransformer
from repro_torch.configs import get_smoke_config
from repro_torch.models import api, convert, layers, transformer

torch.set_num_threads(1)

SLICE_ARCHS = ["qwen2-72b", "starcoder2-15b", "minitron-4b", "phi3-mini-3.8b", "internvl2-26b"]
LOGIT_ATOL, LOGIT_RTOL, LOGIT_REL = 1e-1, 2e-2, 2e-2
LOSS_ATOL = 5e-3
INIT_DIFF_SHARE = 1e-4
OP_BY_OP_SHARE = 1e-3
BF16_ULP = 2.0 ** -7
BF = ml_dtypes.bfloat16


def _kd(k):
    return np.asarray(k, np.uint32)


def _ref_params(arch):
    return jax.tree.map(np.asarray, japi.init(jsmoke(arch), jax.random.PRNGKey(0)))


_MODELS = {}


def _models(arch):
    """(reference params as numpy, the port's model from them), once per arch."""
    if arch not in _MODELS:
        ref = _ref_params(arch)
        _MODELS[arch] = ref, convert.params_from_reference(ref, get_smoke_config(arch),
                                                           device="cpu")
    return _MODELS[arch]


def _batch(cfg, batch=2, seq=16, seed=1):
    """test_smoke_archs.make_batch's draws: tokens, labels, patch embeddings."""
    kt, ke = jax.random.split(jax.random.PRNGKey(seed))
    tokens = np.asarray(jax.random.randint(kt, (batch, seq), 0, cfg.vocab_size))
    out = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.frontend == "patch":
        out["extra_embeds"] = np.asarray(jax.random.normal(ke, (batch, 4, cfg.d_model)))
    return out


def _tb(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i" else v.copy())
            for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _logits_close(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    assert np.linalg.norm(got - want) <= LOGIT_REL * np.linalg.norm(want)


# --- against the reference ------------------------------------------------------------

@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_forward_and_loss_match_reference(arch):
    ref, model = _models(arch)
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    b = _batch(cfg)
    want, _ = jtransformer.forward(ref, jcfg, jnp.asarray(b["tokens"]),
                                   None if "extra_embeds" not in b else jnp.asarray(b["extra_embeds"]))
    tb = _tb(b)
    with torch.no_grad():
        got, aux = transformer.forward(model, cfg, tb["tokens"], tb.get("extra_embeds"))
        loss, metrics = api.loss(model, cfg, tb)
    assert got.dtype == torch.bfloat16 and float(aux) == 0.0
    _logits_close(got, want)
    wloss, wmetrics = japi.loss(ref, jcfg, _jb(b))
    assert abs(float(loss) - float(wloss)) <= LOSS_ATOL
    assert abs(float(metrics["nll"]) - float(wmetrics["nll"])) <= LOSS_ATOL


@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    ref, model = _models(arch)
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    b = _batch(cfg, seq=12)
    n_extra = 4 if cfg.frontend == "patch" else 0
    pre = {k: (v[:, :-1] if k == "tokens" else v) for k, v in b.items() if k != "labels"}
    wl, wstate = japi.prefill(ref, jcfg, _jb(pre), 16 + n_extra)
    wd, _ = japi.decode(ref, jcfg, jnp.asarray(b["tokens"][:, -1]), wstate, jnp.int32(11 + n_extra))
    with torch.no_grad():
        gl, gstate = api.prefill(model, cfg, _tb(pre), 16 + n_extra)
        gd, _ = api.decode(model, cfg, torch.from_numpy(b["tokens"][:, -1].astype(np.int64)),
                           gstate, 11 + n_extra)
    assert gl.dtype == torch.float32 and gd.dtype == torch.float32
    _logits_close(gl, wl)
    _logits_close(gd, wd)
    # the caches: the same slots filled, the same positions
    wk = wstate["blocks"][0]
    np.testing.assert_array_equal(gstate["blocks"][0][0]["pos"].numpy(), np.asarray(wk["pos"][0]))


def _kinds_cfg(mod):
    """qwen2's smoke widths over all four attention block kinds."""
    import dataclasses
    return dataclasses.replace(mod("qwen2-72b"), num_layers=4, window=6, chunk=4,
                               pattern=("attn_local", "attn_chunk", "attn", "attn_global"))


def test_every_attention_block_kind_matches_reference():
    """A stack of attn_local, attn_chunk, attn and attn_global blocks (the
    last without RoPE): forward, and decode steps rolling past the local and
    chunked layers' bounded caches (6 and 4 slots of t_cache 16)."""
    cfg, jcfg = _kinds_cfg(get_smoke_config), _kinds_cfg(jsmoke)
    ref = jax.tree.map(np.asarray, japi.init(jcfg, jax.random.PRNGKey(0)))
    model = convert.params_from_reference(ref, cfg, device="cpu")
    b = _batch(cfg, seq=14)
    t = torch.from_numpy(b["tokens"].astype(np.int64))
    want, _ = jtransformer.forward(ref, jcfg, jnp.asarray(b["tokens"]))
    with torch.no_grad():
        got, _ = transformer.forward(model, cfg, t)
    _logits_close(got, want)
    wl, ws = japi.prefill(ref, jcfg, {"tokens": jnp.asarray(b["tokens"][:, :5])}, 16)
    with torch.no_grad():
        gl, gs = api.prefill(model, cfg, {"tokens": t[:, :5]}, 16)
    _logits_close(gl, wl)
    assert [tuple(st["k"].shape) for st in (gs["blocks"][i][0] for i in range(4))] == \
        [(2, 6, 2, 16), (2, 4, 2, 16), (2, 16, 2, 16), (2, 16, 2, 16)]
    jref = jax.tree.map(jnp.asarray, ref)
    jdecode = jax.jit(lambda tok, st, pos: japi.decode(jref, jcfg, tok, st, pos))
    for pos in range(5, 14):
        wl, ws = jdecode(jnp.asarray(b["tokens"][:, pos]), ws, jnp.int32(pos))
        with torch.no_grad():
            gl, gs = api.decode(model, cfg, t[:, pos], gs, pos)
        _logits_close(gl, wl)
        for i in range(4):
            np.testing.assert_array_equal(gs["blocks"][i][0]["pos"].numpy(),
                                          np.asarray(ws["blocks"][i]["pos"][0]))


def test_minitron_matches_reference_op_by_op():
    """Run op by op, the reference rounds each bf16 op as its code reads, as
    the port does: forward, prefill and decode logits equal but where a float32
    sum's order flips a bf16 rounding."""
    arch = "minitron-4b"
    ref, model = _models(arch)
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    b = _batch(cfg, seq=12)
    with jax.disable_jit():
        want, _ = jtransformer.forward(ref, jcfg, jnp.asarray(b["tokens"]))
        wl, wstate = japi.prefill(ref, jcfg, {"tokens": jnp.asarray(b["tokens"][:, :-1])}, 16)
        wd, _ = japi.decode(ref, jcfg, jnp.asarray(b["tokens"][:, -1]), wstate, jnp.int32(11))
    t = torch.from_numpy(b["tokens"].astype(np.int64))
    with torch.no_grad():
        got, _ = transformer.forward(model, cfg, t)
        gl, gstate = api.prefill(model, cfg, {"tokens": t[:, :-1]}, 16)
        gd, _ = api.decode(model, cfg, t[:, -1], gstate, 11)
    for g, w in ((got.float().numpy(), want), (gl.numpy(), wl), (gd.numpy(), wd)):
        w = np.asarray(w).astype(np.float32)
        np.testing.assert_allclose(g, w, rtol=BF16_ULP, atol=1e-30)
        assert np.mean(g != w) <= OP_BY_OP_SHARE


@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_own_init_equals_reference_init_but_at_bf16_boundaries(arch):
    ref = _ref_params(arch)
    model = api.init(get_smoke_config(arch), _kd(jax.random.PRNGKey(0)), device="cpu")
    got = dict(model.named_parameters())
    exact = 0
    leaves = 0
    for path, leaf in jtu.tree_leaves_with_path(ref):
        ks = jtu.keystr(path)
        stacked = ks.startswith("['blocks']")
        for r in range(leaf.shape[0]) if stacked else [None]:
            want = (leaf[r] if stacked else leaf).astype(np.float32)
            mine = got[convert.state_dict_key(ks, r)].detach().float().numpy()
            assert mine.shape == want.shape, ks
            differ = int((mine != want).sum())
            assert differ <= INIT_DIFF_SHARE * want.size, (ks, differ)
            exact += differ == 0
            leaves += 1
    assert leaves == len(got) and exact >= leaves - 2


@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_convert_round_trip(arch):
    ref, model = _models(arch)
    back = convert.params_to_reference(model)
    assert jtu.tree_structure(back) == jtu.tree_structure(ref)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    # float32 views of the bf16 leaves (a checkpoint's form) take the port's dtypes
    f32 = jax.tree.map(lambda a: a.astype(np.float32), ref)
    again = convert.params_from_reference(f32, get_smoke_config(arch), device="cpu")
    for (n, p), (m, q) in zip(model.named_parameters(), again.named_parameters()):
        assert n == m and p.dtype == q.dtype and torch.equal(p, q)


def test_state_dict_keys_follow_the_reference_paths():
    assert convert.state_dict_key("['embed']") == "embed"
    assert convert.state_dict_key("['final_norm']['scale']") == "final_norm.scale"
    assert convert.state_dict_key("['blocks'][0]['attn']['wq']", 3) == "blocks.0.3.attn.wq"
    with pytest.raises(ValueError):
        convert.state_dict_key("['blocks'][0]['attn']['wq']")
    model = api.init(get_smoke_config("qwen2-72b"), _kd(jax.random.PRNGKey(0)), device="meta")
    keys = list(model.state_dict())
    assert keys[:3] == ["embed", "unembed", "final_norm.scale"]
    assert "blocks.0.1.mlp.wg" in keys and "blocks.0.0.attn.bq" in keys


def test_float32_leaf_that_is_not_bf16_is_refused():
    ref = _ref_params("phi3-mini-3.8b")
    ref = jax.tree.map(lambda a: a.astype(np.float32), ref)
    ref["embed"] = ref["embed"] + np.float32(1e-4)
    with pytest.raises(ValueError, match="does not hold"):
        convert.params_from_reference(ref, get_smoke_config("phi3-mini-3.8b"), device="cpu")


# --- mirrors of tests/models/test_smoke_archs.py ---------------------------------------

@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_forward_output_shape(arch):
    cfg = get_smoke_config(arch)
    model = api.init(cfg, _kd(jax.random.PRNGKey(0)), device="cpu")
    b = _tb(_batch(cfg))
    with torch.no_grad():
        logits, _ = transformer.forward(model, cfg, b["tokens"], b.get("extra_embeds"))
    extra = 0 if "extra_embeds" not in b else b["extra_embeds"].shape[1]
    assert tuple(logits.shape) == (2, 16 + extra, layers.pad_vocab(cfg.vocab_size))
    assert bool(torch.isfinite(logits.float()).all())


@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_prefill_decode_consistency(arch):
    """decode_step(t) after prefill(t-1 tokens) == forward logits at position t."""
    cfg = get_smoke_config(arch)
    model = api.init(cfg, _kd(jax.random.PRNGKey(0)), device="cpu")
    b = _tb(_batch(cfg, seq=12))
    tokens = b["tokens"]
    n_extra = b["extra_embeds"].shape[1] if cfg.frontend == "patch" else 0
    pre = dict(b, tokens=tokens[:, :-1])
    with torch.no_grad():
        logits_pre, state = api.prefill(model, cfg, pre, 16 + n_extra)
        logits_dec, _ = api.decode(model, cfg, tokens[:, -1], state, 11 + n_extra)
        full, _ = transformer.forward(model, cfg, tokens, b.get("extra_embeds"))
    np.testing.assert_allclose(logits_pre.numpy(), full[:, -2].float().numpy(), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(logits_dec.numpy(), full[:, -1].float().numpy(), atol=1e-1, rtol=1e-1)


@pytest.mark.parametrize("arch", SLICE_ARCHS)
def test_train_step_smoke_loss(arch):
    """The loss part of test_train_step_smoke: finite, near log(vocab); the
    gradients come with the training stack."""
    cfg = get_smoke_config(arch)
    model = api.init(cfg, _kd(jax.random.PRNGKey(0)), device="cpu")
    with torch.no_grad():
        loss, metrics = api.loss(model, cfg, _tb(_batch(cfg)))
    assert loss.shape == () and np.isfinite(float(loss))
    assert 1.0 < float(loss) < 3.0 * np.log(cfg.vocab_size)
    assert sorted(metrics) == ["aux", "nll"]


def test_checkpointed_forward_equals_plain_forward():
    """With grad enabled each repetition runs under torch.utils.checkpoint."""
    cfg = get_smoke_config("phi3-mini-3.8b")
    model = api.init(cfg, _kd(jax.random.PRNGKey(0)), device="cpu")
    b = _tb(_batch(cfg))
    with torch.no_grad():
        plain, _ = transformer.forward(model, cfg, b["tokens"])
    loss = transformer.forward(model, cfg, b["tokens"])[0].float().square().mean()
    assert loss.requires_grad
    ckpt, _ = transformer.forward(model, cfg, b["tokens"])
    assert torch.equal(ckpt.detach(), plain)


# --- what the slice does not port -----------------------------------------------------

@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-350m", "llama4-scout-17b-a16e",
                                  "deepseek-v3-671b", "seamless-m4t-large-v2"])
def test_unported_kinds_raise_and_name_the_roadmap(arch):
    cfg = get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 2"):
        api.init(cfg, _kd(jax.random.PRNGKey(0)), device="cpu")


@pytest.mark.parametrize("kind", ["mla", "rec", "mlstm", "slstm"])
def test_unported_block_kinds_raise(kind):
    cfg = get_smoke_config("qwen2-72b")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 2"):
        transformer.block_init(_kd(jax.random.PRNGKey(0)), cfg, kind, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 2"):
        transformer.block_init_state(cfg, kind, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 2"):
        transformer.block_apply({"norm1": {"scale": torch.ones(cfg.d_model)}},
                                torch.zeros(1, 2, cfg.d_model, dtype=torch.bfloat16), cfg, kind,
                                positions=torch.arange(2))


def test_context_is_the_single_device_half():
    """No mesh: constrain is the identity, no batch axes; meshes raise."""
    from repro.distributed import context as jcontext
    from repro_torch.distributed import context
    x = torch.arange(6).reshape(2, 3)
    assert context.current_mesh() is None and jcontext.current_mesh() is None
    assert context.batch_axes() == jcontext.batch_axes() == ()
    assert context.constrain(x, "batch", "model") is x
    assert jcontext.constrain(x, "batch", "model") is x
    for fn in (lambda: context.mesh_context(None), context.frame_mesh):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 5"):
            fn()


def test_entry_points_default_to_the_card():
    """Without a card, every entry point that would place tensors raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run there")
    cfg = get_smoke_config("qwen2-72b")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init(cfg, _kd(jax.random.PRNGKey(0)))
    with pytest.raises(RuntimeError, match="CUDA"):
        layers.init_kv_cache(1, 4, 2, 16)
    from repro_torch.serve import EngineConfig, ServeEngine
    model = api.init(cfg, _kd(jax.random.PRNGKey(0)), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, model, EngineConfig())
