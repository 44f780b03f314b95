"""The port's model stack (``repro_torch.models.{transformer,encdec,api,convert}``)
against the live reference at the smoke configs of all ten LM archs, with the
reference's own weights carried across by ``convert``.

Tolerances:

* logits of ``forward``, ``prefill`` and ``decode``: within LOGIT_ATOL +
  LOGIT_RTOL * |x|, and the relative Frobenius error under LOGIT_REL.  The
  reference runs compiled (``jax.jit`` of each entry point), and XLA keeps some bf16 intermediates in float32
  (the residual stream into a norm, the activations inside ``jax.nn.silu`` /
  ``gelu``) where the port rounds each op as the code is written; a 2-layer
  smoke model then differs by a few bf16 ulp of its logits.  The recurrent
  archs amplify such ulps: RG-LRU's decay is ``exp(-8 softplus(lambda) r)``
  of a gate ``r`` rounded to bf16 first, so one ulp of ``r`` moves the decay
  by up to 3 %, and xLSTM's four mixers are exponentially gated.  Their
  logits are held within RECURRENT_ATOL and RECURRENT_REL (port against the
  compiled reference at this seed: recurrentgemma max 0.125, relative
  2.4e-2; xlstm 0.18, 2.3e-2; the reference compiled against itself run op
  by op: 0.055, 9.6e-3 and 0.148, 1.5e-2; with float32 weights the port
  and the reference agree within 1e-5).
  Run op by op (``jax.disable_jit``) the reference rounds
  as the port does, and the arch whose MLP has no such activation
  (minitron, relu2) is bit for bit but where a float32 reduction, summed in
  another order, flips a bf16 rounding: at most OP_BY_OP_SHARE of the
  logits differ, each by one bf16 ulp;
* with float32 weights the forward of every decoder arch within F32_ATOL +
  F32_RTOL * |x|: the same formulas, float32 sums in other orders;
* MoE routing first.  A float32 router logit summed in another order can
  move a near-tie and flip a token's expert, and that token's output then
  differs by a whole expert, and so does every later position of its row
  (attention).  So the expert ids of every router call are compared first:
  at most ROUTE_SHARE of the tokens may disagree, each at a reference top-k
  margin (the least gap between adjacent scores among the first k + 1,
  where the ordered top k can change) under ROUTE_MARGIN, and the
  logits are held at the positions of each row before its first
  disagreement; the loss only where no token disagrees;
* the loss: within LOSS_ATOL;
* the port's own ``init`` from the same key: equal to the reference's except
  at bf16 rounding boundaries (``prng.normal`` is within a few ulp of
  ``jax.random.normal``): at most INIT_DIFF_SHARE of a bf16 leaf's elements
  differ, and for the archs ported after the attention-only five, whose
  models hold more small leaves, one element in a leaf smaller than
  1 / INIT_DIFF_SHARE (a 4096-value leaf of seamless holds one value at such
  a boundary); float32 leaves (MoE routers, xLSTM gates) within INIT_F32_ULP ulp,
  and ``lambda_raw`` (a uniform draw) bit for bit;
* ``convert`` both ways: leaf for leaf, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as R
from repro.configs import get_smoke_config as jsmoke
from repro.models import api as japi
from repro.models import encdec as jencdec
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro_torch.configs import get_smoke_config
from repro_torch.models import api, convert, encdec, layers, moe, transformer

torch.set_num_threads(1)

ARCHS = [a for a in R.ARCH_IDS if a != "paper-bayes-fusion"]
DECODER_ARCHS = [a for a in ARCHS if a != "seamless-m4t-large-v2"]
ATTENTION_ONLY = ["qwen2-72b", "starcoder2-15b", "minitron-4b", "phi3-mini-3.8b", "internvl2-26b"]
LOGIT_ATOL, LOGIT_RTOL, LOGIT_REL = 1e-1, 2e-2, 2e-2
RECURRENT_ATOL, RECURRENT_REL = 2e-1, 3e-2
RECURRENT = ("recurrentgemma-2b", "xlstm-350m")
F32_ATOL, F32_RTOL = 1e-4, 1e-4
ROUTE_SHARE, ROUTE_MARGIN = 0.125, 2e-2
LOSS_ATOL = 5e-3
INIT_DIFF_SHARE = 1e-4
INIT_F32_ULP = 4
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
    """test_smoke_archs.make_batch's draws: tokens, labels, patch or frame embeddings."""
    kt, ke = jax.random.split(jax.random.PRNGKey(seed))
    tokens = np.asarray(jax.random.randint(kt, (batch, seq), 0, cfg.vocab_size))
    out = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.frontend == "patch":
        out["extra_embeds"] = np.asarray(jax.random.normal(ke, (batch, 4, cfg.d_model)))
    elif cfg.frontend == "frame":
        out["extra_embeds"] = np.asarray(jax.random.normal(
            ke, (batch, seq // cfg.enc_ratio, cfg.d_model)))
    return out


def _tb(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i" else v.copy())
            for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _n_extra(cfg):
    return 4 if cfg.frontend == "patch" else 0


def _tol(arch):
    """(atol, relative Frobenius bound) of an arch's logits."""
    return (RECURRENT_ATOL, RECURRENT_REL) if arch in RECURRENT else (LOGIT_ATOL, LOGIT_REL)


def _logits_close(got, want, tol=(LOGIT_ATOL, LOGIT_REL)):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol[0], rtol=LOGIT_RTOL)
    assert np.linalg.norm(got - want) <= tol[1] * np.linalg.norm(want)


def _forward(mod_tr, mod_ed, params, cfg, batch):
    """Teacher-forced logits of either family (``batch`` of the module's arrays)."""
    if cfg.family == "audio":
        return mod_ed.forward(params, cfg, batch["extra_embeds"], batch["tokens"])
    return mod_tr.forward(params, cfg, batch["tokens"], batch.get("extra_embeds"))


class _Routes:
    """Records every MoE router call's (logits, expert ids): in the reference
    through a debug callback (compiled or not), in the port directly."""

    def __enter__(self):
        self.ref, self.port = [], []
        self._j, self._t = jmoe._router_probs, moe._router_probs

        def jrec(logits, kind, k):
            out = self._j(logits, kind, k)
            jax.debug.callback(lambda l, i: self.ref.append((np.asarray(l), np.asarray(i))),
                               logits, out[1], ordered=True)
            return out

        def trec(logits, kind, k):
            out = self._t(logits, kind, k)
            self.port.append((logits.detach().numpy().copy(), out[1].numpy().copy()))
            return out
        jmoe._router_probs, moe._router_probs = jrec, trec
        return self

    def __exit__(self, *exc):
        jmoe._router_probs, moe._router_probs = self._j, self._t

    def first_flip(self, cfg, rows: int, calls=None, first=None):
        """Per batch row, the first position whose expert ids differ in any of
        the router calls ``calls`` (all by default, in call order), or the
        row's length.  A token at or past its row's first disagreement in an
        earlier call has another input by then, so only the tokens before it
        are held to the stated share and margin; ``first`` carries such
        positions in from earlier calls (a prefill's, before its decode)."""
        jax.effects_barrier()
        assert len(self.ref) == len(self.port)
        pairs = list(zip(self.ref, self.port))
        pairs = pairs if calls is None else [pairs[i] for i in calls]
        n_tok, n_bad = 0, 0
        for (jl, ji), (_, ti) in pairs:
            s = ji.shape[0] // rows
            if first is None:
                first = np.full(rows, s)
            clean = (np.arange(s)[None, :] < first[:, None]).reshape(-1)
            differ = (ji != ti).any(-1) & clean
            n_tok, n_bad = n_tok + int(clean.sum()), n_bad + int(differ.sum())
            if differ.any():
                scores = jax.nn.sigmoid(jl) if cfg.moe.router == "sigmoid" else \
                    jax.nn.softmax(jl, axis=-1)
                # the order of the top k changes where two adjacent scores of
                # the first k + 1 trade places
                top = -np.sort(-np.asarray(scores), axis=-1)[:, : cfg.moe.top_k + 1]
                margin = (top[:, :-1] - top[:, 1:]).min(-1)
                print(f"routing differs at tokens {np.nonzero(differ)[0].tolist()}: "
                      f"reference top-k margins {margin[differ].tolist()}")
                assert (margin[differ] < ROUTE_MARGIN).all()
            differ = differ.reshape(rows, s)
            first = np.minimum(first, np.where(differ.any(1), differ.argmax(1), s))
        assert n_bad <= ROUTE_SHARE * max(n_tok, 1), (n_bad, n_tok)
        return first


# --- against the reference ------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    ref, model = _models(arch)
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    b = _batch(cfg)
    tb = _tb(b)
    with _Routes() as routes:
        want, _ = jax.jit(lambda p, b: _forward(jtransformer, jencdec, p, jcfg, b))(ref, _jb(b))
        with torch.no_grad():
            got, aux = _forward(transformer, encdec, model, cfg, tb)
        first = routes.first_flip(cfg, 2) if cfg.moe else None
    assert got.dtype == torch.bfloat16
    if not cfg.moe:
        assert float(aux) == 0.0
        _logits_close(got, want, _tol(arch))
    else:
        # the positions of each row before its first routing disagreement
        n = _n_extra(cfg)
        for row, f in enumerate(first):
            if f > 0:
                _logits_close(got[row, n:n + f], np.asarray(want)[row, n:n + f])
    with _Routes() as routes:
        wloss, wmetrics = jax.jit(lambda p, b: japi.loss(p, jcfg, b))(ref, _jb(b))
        with torch.no_grad():
            loss, metrics = api.loss(model, cfg, tb)
        first = routes.first_flip(cfg, 2) if cfg.moe else None
    assert sorted(metrics) == sorted(wmetrics)
    if first is None or (first == 16).all():
        for name in metrics:
            assert abs(float(metrics[name]) - float(wmetrics[name])) <= LOSS_ATOL, name
        assert abs(float(loss) - float(wloss)) <= LOSS_ATOL


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_forward_in_float32_weights_matches_reference(arch):
    """Every leaf cast to float32 in both packages: the same formulas, so
    the logits agree to float32 rounding and routing cannot flip."""
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    ref = jax.tree.map(lambda a: np.asarray(a).astype(np.float32), _models(arch)[0])
    model = convert.params_from_reference(ref, device="cpu")
    b = _batch(cfg)
    want, _ = jtransformer.forward(jax.tree.map(jnp.asarray, ref), jcfg, jnp.asarray(b["tokens"]),
                                   None if "extra_embeds" not in b else jnp.asarray(b["extra_embeds"]))
    tb = _tb(b)
    with torch.no_grad():
        got, _ = transformer.forward(model, cfg, tb["tokens"], tb.get("extra_embeds"))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL, rtol=F32_RTOL)


def _pos_of_first_cache(state, family):
    if family == "audio":
        return state["self"][0]["pos"]
    st = state["prefix"][0] if state["prefix"] else state["blocks"][0]
    return st.get("pos") if isinstance(st, dict) else st[0].get("pos")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    ref, model = _models(arch)
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    b = _batch(cfg, seq=12)
    n_extra = _n_extra(cfg)
    pre = {k: (v[:, :-1] if k == "tokens" else v) for k, v in b.items() if k != "labels"}
    with _Routes() as routes:
        wl, wstate = jax.jit(lambda p, b: japi.prefill(p, jcfg, b, 16 + n_extra))(ref, _jb(pre))
        wd, _ = jax.jit(lambda p, t, s, pos: japi.decode(p, jcfg, t, s, pos))(
            ref, jnp.asarray(b["tokens"][:, -1]), wstate, jnp.int32(11 + n_extra))
        with torch.no_grad():
            gl, gstate = api.prefill(model, cfg, _tb(pre), 16 + n_extra)
            gd, _ = api.decode(model, cfg, torch.from_numpy(b["tokens"][:, -1].astype(np.int64)),
                               gstate, 11 + n_extra)
        held = np.ones(2, bool)
        if cfg.moe:
            n_layers = len(routes.ref) // 2
            pre_first = routes.first_flip(cfg, 2, range(n_layers))
            dec_first = routes.first_flip(cfg, 2, range(n_layers, 2 * n_layers),
                                          np.where(pre_first == 11 + n_extra, 1, 0))
            held = dec_first == 1
    assert gl.dtype == torch.float32 and gd.dtype == torch.float32
    assert held.any()
    _logits_close(gl[held], np.asarray(wl)[held], _tol(arch))
    _logits_close(gd[held], np.asarray(wd)[held], _tol(arch))
    # the caches: the same slots filled, the same positions
    gpos = _pos_of_first_cache(gstate, cfg.family)
    if cfg.family == "audio":
        np.testing.assert_array_equal(gpos.numpy(), np.asarray(wstate["self"]["pos"][0]))
    elif gpos is not None:
        wst = wstate["prefix"][0] if wstate["prefix"] else jax.tree.map(lambda a: a[0],
                                                                         wstate["blocks"][0])
        np.testing.assert_array_equal(gpos.numpy(), np.asarray(wst["pos"]))
    # every state leaf of the decoder: the reference's shape and dtype
    if cfg.family != "audio":
        for i, kind in enumerate(cfg.pattern):
            for name, leaf in wstate["blocks"][i].items():
                mine = gstate["blocks"][i][0][name]
                assert tuple(mine.shape) == leaf.shape[1:] and str(mine.dtype)[6:] == \
                    str(leaf.dtype), (kind, name)


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


def _stacked(keystr):
    return keystr.startswith(("['blocks']", "['enc_blocks']", "['dec_blocks']"))


@pytest.mark.parametrize("arch", ARCHS)
def test_own_init_equals_reference_init_but_at_bf16_boundaries(arch):
    ref = _ref_params(arch)
    model = api.init(get_smoke_config(arch), _kd(jax.random.PRNGKey(0)), device="cpu")
    got = dict(model.named_parameters())
    exact = 0
    leaves = 0
    for path, leaf in jtu.tree_leaves_with_path(ref):
        ks = jtu.keystr(path)
        stacked = _stacked(ks)
        for r in range(leaf.shape[0]) if stacked else [None]:
            want = leaf[r] if stacked else leaf
            p = got[convert.state_dict_key(ks, r)]
            assert tuple(p.shape) == want.shape, ks
            mine = p.detach().float().numpy()
            if want.dtype == np.float32:
                assert p.dtype == torch.float32, ks
                np.testing.assert_allclose(mine, want, rtol=INIT_F32_ULP * 2.0 ** -23, atol=0)
                if ks.endswith("['lambda_raw']"):
                    np.testing.assert_array_equal(mine, want)
                differ = 0 if ks.endswith("['scale']") or ks.endswith("['bias']") else None
            else:
                differ = int((mine != want.astype(np.float32)).sum())
                allowed = INIT_DIFF_SHARE * want.size
                assert differ <= (allowed if arch in ATTENTION_ONLY else max(1, allowed)), \
                    (ks, differ)
            exact += differ == 0
            leaves += 1
    assert leaves == len(got) and exact >= leaves - 2 - sum(
        1 for p in jax.tree.leaves(ref) if p.dtype == np.float32 and p.ndim > 1)


@pytest.mark.parametrize("arch", ARCHS)
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
    assert convert.state_dict_key("['enc_blocks']['attn']['wq']", 1) == "enc_blocks.1.attn.wq"
    assert convert.state_dict_key("['mtp']['block']['moe']['wi']") == "mtp.block.moe.wi"
    model = api.init(get_smoke_config("qwen2-72b"), _kd(jax.random.PRNGKey(0)), device="meta")
    keys = list(model.state_dict())
    assert keys[:3] == ["embed", "unembed", "final_norm.scale"]
    assert "blocks.0.1.mlp.wg" in keys and "blocks.0.0.attn.bq" in keys
    model = api.init(get_smoke_config("deepseek-v3-671b"), _kd(jax.random.PRNGKey(0)),
                     device="meta")
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes["blocks.0.1.moe.wi"] == (4, 64, 64) and shapes["prefix.0.attn.q_norm.scale"] == (32,)
    assert shapes["mtp.proj"] == (128, 64) and "mtp.block.moe.router" in shapes
    model = api.init(get_smoke_config("seamless-m4t-large-v2"), _kd(jax.random.PRNGKey(0)),
                     device="meta")
    assert "dec_blocks.1.cross_attn.wk" in model.state_dict() and "enc_norm.scale" in \
        model.state_dict()


def test_float32_leaf_that_is_not_bf16_is_refused():
    ref = _ref_params("phi3-mini-3.8b")
    ref = jax.tree.map(lambda a: a.astype(np.float32), ref)
    ref["embed"] = ref["embed"] + np.float32(1e-4)
    with pytest.raises(ValueError, match="does not hold"):
        convert.params_from_reference(ref, get_smoke_config("phi3-mini-3.8b"), device="cpu")


# --- mirrors of tests/models/test_smoke_archs.py ---------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_output_shape(arch):
    cfg = get_smoke_config(arch)
    model = api.init(cfg, _kd(jax.random.PRNGKey(0)), device="cpu")
    b = _tb(_batch(cfg))
    with torch.no_grad():
        logits, _ = _forward(transformer, encdec, model, cfg, b)
    extra = _n_extra(cfg)
    assert tuple(logits.shape) == (2, 16 + extra, layers.pad_vocab(cfg.vocab_size))
    assert bool(torch.isfinite(logits.float()).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """decode_step(t) after prefill(t-1 tokens) == forward logits at position t."""
    cfg = get_smoke_config(arch)
    model = api.init(cfg, _kd(jax.random.PRNGKey(0)), device="cpu")
    b = _tb(_batch(cfg, seq=12))
    tokens = b["tokens"]
    n_extra = _n_extra(cfg)
    pre = dict(b, tokens=tokens[:, :-1])
    with torch.no_grad():
        logits_pre, state = api.prefill(model, cfg, pre, 16 + n_extra)
        logits_dec, _ = api.decode(model, cfg, tokens[:, -1], state, 11 + n_extra)
        full, _ = _forward(transformer, encdec, model, cfg, b)
    np.testing.assert_allclose(logits_pre.numpy(), full[:, -2].float().numpy(), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(logits_dec.numpy(), full[:, -1].float().numpy(), atol=1e-1, rtol=1e-1)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_smoke_loss(arch):
    """The loss part of test_train_step_smoke: finite, near log(vocab); the
    gradients come with the training stack."""
    cfg = get_smoke_config(arch)
    model = api.init(cfg, _kd(jax.random.PRNGKey(0)), device="cpu")
    with torch.no_grad():
        loss, metrics = api.loss(model, cfg, _tb(_batch(cfg)))
    assert loss.shape == () and np.isfinite(float(loss))
    assert 1.0 < float(loss) < 3.0 * np.log(cfg.vocab_size)
    assert sorted(metrics) == sorted(["aux", "nll"] + (["mtp_nll"] if cfg.mtp_heads else []))


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


# --- the single-device scope ------------------------------------------------------

def test_context_is_the_single_device_half():
    """No mesh: constrain is the identity, no batch axes; with no process
    group started there is one device, so ``frame_mesh`` of 1 is no mesh and
    of more raises."""
    from repro.distributed import context as jcontext
    from repro_torch.distributed import context
    x = torch.arange(6).reshape(2, 3)
    assert context.current_mesh() is None and jcontext.current_mesh() is None
    assert context.batch_axes() == jcontext.batch_axes() == ()
    assert context.constrain(x, "batch", "model") is x
    assert jcontext.constrain(x, "batch", "model") is x
    with context.mesh_context(None):
        assert context.current_mesh() is None and context.constrain(x, "batch") is x
    assert context.frame_mesh() is None and context.frame_mesh(1) is None
    with pytest.raises(ValueError, match="devices=2 needs a started process group"):
        context.frame_mesh(2)


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
