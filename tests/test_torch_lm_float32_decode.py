"""Serving with float32 weights, as after a microbatched train step (the new
params take the float32 of the summed gradients in both packages): the
port's prefill and decode against the live reference for every decoder arch
of the smoke configs, and a microbatched ``TrainLoop`` step followed by
``ServeEngine`` decode against the reference's engine on the same params.

The caches stay bf16.  A decode step's attention output then has the cache's
dtype, and the reference's ``@`` promotes it to float32 against the float32
out-projection; the port does the same (``layers.matmul``).

Tolerances:

* the logits of a prefill, and of each decode step taken from the
  reference's own state: within the model tests' float32 bounds, F32_ATOL +
  F32_RTOL * |x| (the same formulas, float32 sums in other orders);
* each state leaf those steps return: a float32 leaf within F32_ATOL of its
  largest value; a bf16 leaf (the caches) equal, but where the float32 value
  it rounds lies at a bf16 rounding boundary -- at most BF16_FLIP_SHARE of its
  elements, each one bf16 ulp of the value away;
* the logits of the port's own chain of decode steps (its own caches, whose
  flipped ulps the later steps carry) within the model tests' bf16 bounds,
  as are the logits each engine feeds its gate after the first step; the
  first (a prefill's, all float32) within the float32 bounds.  The engines'
  tokens are held until the first step at a near tie of the gate, where the
  runs part (``test_torch_lm_engine.py``'s rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as R
from repro.configs import get_smoke_config as jsmoke
from repro.models import api as japi
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core import prng
from repro_torch.data import DataConfig
from repro_torch.models import api, convert, layers
from repro_torch.models import bayes_head
from repro_torch.optim import adamw
from repro_torch.serve import EngineConfig, Request, ServeEngine
from repro_torch.serve import engine as tengine
from repro_torch.train import TrainConfig, TrainLoop

torch.set_num_threads(1)

DECODER_ARCHS = [a for a in R.ARCH_IDS if a not in ("paper-bayes-fusion", "seamless-m4t-large-v2")]
RECURRENT = ("recurrentgemma-2b", "xlstm-350m")
F32_ATOL, F32_RTOL = 1e-4, 1e-4
LOGIT_ATOL, LOGIT_RTOL, LOGIT_REL = 1e-1, 2e-2, 2e-2
RECURRENT_ATOL, RECURRENT_REL = 2e-1, 3e-2
BF16_FLIP_SHARE = 1e-2
BF16_ULP = 2.0 ** -7            # a bf16 ulp relative to the value (8 significant bits)
DECODE_STEPS = 3
MARGIN = 1e-2


def _float32_params(arch):
    """The reference's smoke params with every leaf cast to float32 (numpy),
    and the port's model of the same float32 leaves."""
    ref = jax.tree.map(lambda a: np.asarray(a).astype(np.float32),
                       japi.init(jsmoke(arch), jax.random.PRNGKey(0)))
    return ref, convert.params_from_reference(ref, device="cpu")


def _prompt(cfg, batch=2, seq=11, seed=1):
    kt, ke = jax.random.split(jax.random.PRNGKey(seed))
    out = {"tokens": np.asarray(jax.random.randint(kt, (batch, seq), 0, cfg.vocab_size))}
    if cfg.frontend == "patch":
        out["extra_embeds"] = np.asarray(jax.random.normal(ke, (batch, 4, cfg.d_model)))
    return out


def _to_port(tree):
    """A reference decode-state subtree (numpy or jax leaves) as the port's tensors."""
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _port_state(wstate, cfg):
    """The reference's state (``blocks`` stacked over repetitions) in the
    port's layout (a list of one state per repetition)."""
    reps = (cfg.num_layers - len(cfg.prefix_kinds)) // len(cfg.pattern)
    return {"prefix": [_to_port(s) for s in wstate["prefix"]],
            "blocks": tuple([_to_port(jax.tree.map(lambda a: a[r], blk)) for r in range(reps)]
                            for blk in wstate["blocks"])}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _states_close(got, want):
    """``got`` (the port's state) against ``want`` (the reference's, in the
    port's layout), leaf by leaf, by the rules of the module's docstring."""
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        bf16 = a.dtype == torch.bfloat16
        a, b = a.float().numpy(), b.float().numpy()
        diff = np.abs(a - b)
        if bf16:
            assert (diff <= BF16_ULP * np.abs(b)).all()
            assert (diff > 0).sum() <= BF16_FLIP_SHARE * diff.size
        elif a.dtype.kind == "f":
            assert diff.max() <= F32_ATOL * max(float(np.abs(b).max()), 1.0)
        else:
            np.testing.assert_array_equal(a, b)


def _f32_close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL, rtol=F32_RTOL)


def _lm_close(got, want, arch):
    atol, rel = (RECURRENT_ATOL, RECURRENT_REL) if arch in RECURRENT else (LOGIT_ATOL, LOGIT_REL)
    got, want = got.numpy(), np.asarray(want).astype(np.float32)
    np.testing.assert_allclose(got, want, atol=atol, rtol=LOGIT_RTOL)
    assert np.linalg.norm(got - want) <= rel * np.linalg.norm(want)


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_float32_weight_prefill_and_decode_match_reference(arch):
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    ref, model = _float32_params(arch)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    prompt = _prompt(cfg)
    n_extra = 4 if cfg.frontend == "patch" else 0
    t_cache, pos = 16 + n_extra, prompt["tokens"].shape[1] + n_extra
    jparams = jax.tree.map(jnp.asarray, ref)
    wl, wstate = japi.prefill(jparams, jcfg, {k: jnp.asarray(v) for k, v in prompt.items()},
                              t_cache)
    with torch.no_grad():
        gl, gstate = api.prefill(model, cfg,
                                 {k: torch.from_numpy(v.copy()) for k, v in prompt.items()},
                                 t_cache)
    assert gl.dtype == torch.float32
    _f32_close(gl, wl)
    _states_close(gstate, _port_state(wstate, cfg))
    # each step from the reference's own state; the port's chain on its own caches
    token = np.asarray(jnp.argmax(wl, -1))
    for step in range(DECODE_STEPS):
        wd, wnext = japi.decode(jparams, jcfg, jnp.asarray(token), wstate, jnp.int32(pos + step))
        with torch.no_grad():
            gd, gnext = api.decode(model, cfg, torch.from_numpy(token.astype(np.int64)),
                                   _port_state(wstate, cfg), pos + step)
            cd, gstate = api.decode(model, cfg, torch.from_numpy(token.astype(np.int64)),
                                    gstate, pos + step)
        assert gd.dtype == torch.float32
        _f32_close(gd, wd)
        _states_close(gnext, _port_state(wnext, cfg))
        _lm_close(cd, wd, arch)
        wstate, token = wnext, np.asarray(jnp.argmax(wd, -1))


def test_matmul_promotes_as_the_reference_and_keeps_one_dtype_as_it_is():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((3, 5), np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((5, 4), np.float32))
    got = layers.matmul(a, b)
    want = jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) @ jnp.asarray(b.numpy())
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    bb = b.to(torch.bfloat16)
    assert torch.equal(layers.matmul(a, bb), a @ bb)
    with pytest.raises(RuntimeError):
        a @ b


def _record(monkeypatch):
    """The logits each engine hands its gate, per step: the reference's, and
    the port's with the step's key."""
    jcalls, tcalls = [], []
    jreal = JServeEngine._step_impl

    def jstep(eng, key, last_logits):
        jcalls.append(np.asarray(last_logits))
        return jreal(eng, key, last_logits)

    def tgate(ecfg, key, logits, *, device="cuda"):
        tcalls.append((np.asarray(key), logits.detach().numpy().copy()))
        return GATE(ecfg, key, logits, device=device)
    monkeypatch.setattr(JServeEngine, "_step_impl", jstep)
    monkeypatch.setattr(tengine, "emission_gate", tgate)
    return jcalls, tcalls


GATE = tengine.emission_gate


def test_microbatched_train_step_then_engine_decode(monkeypatch, tmp_path):
    """One ``TrainLoop`` step of two microbatches turns every param float32;
    the port's engine then serves on them, and the reference's engine on the
    same params (``convert.params_to_reference``)."""
    arch = "qwen2-72b"
    cfg, jcfg = get_smoke_config(arch), jsmoke(arch)
    loop = TrainLoop(cfg, DataConfig(seed=1, global_batch=4, seq_len=16,
                                     vocab_size=cfg.vocab_size),
                     TrainConfig(steps=1, microbatches=2, ckpt_every=100,
                                 ckpt_dir=str(tmp_path / "ckpt")),
                     adamw.AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=10), device="cpu")
    params, _, _ = loop.run(prng.PRNGKey(0))
    assert {p.dtype for p in params.parameters()} == {torch.float32}
    ref = convert.params_to_reference(params)
    kw = dict(max_batch=3, t_cache=64, stochastic_gate=False)
    ecfg = EngineConfig(**kw)
    jcalls, tcalls = _record(monkeypatch)
    r = np.random.default_rng(5)
    prompts = [r.integers(0, cfg.vocab_size, size=5 + 2 * i).astype(np.int32) for i in range(4)]
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    JServeEngine(jcfg, jax.tree.map(jnp.asarray, ref), JEngineConfig(**kw)).run(
        jax.random.PRNGKey(7), jreqs)
    treqs = [Request(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    ServeEngine(cfg, params, ecfg, device="cpu").run(prng.PRNGKey(7), treqs)
    assert len(tcalls) == len(jcalls) > DECODE_STEPS
    np.testing.assert_allclose(tcalls[0][1], jcalls[0], atol=F32_ATOL, rtol=F32_RTOL)
    held = 0
    for (key, got), want in zip(tcalls, jcalls):
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
        # the gate on each engine's logits, with the step's key
        t_got, t_want = (GATE(ecfg, key, torch.from_numpy(x.copy()), device="cpu")[0]
                         for x in (got, want))
        if not torch.equal(t_got, t_want):
            # the runs part only at a near tie of the gate's fused posteriors
            src = torch.from_numpy(want.copy())
            temp = torch.full((), ecfg.ensemble_temp)
            score = bayes_head.fuse_posteriors(torch.stack([src, src / temp]), top_k=8,
                                               device="cpu")[2]
            top2 = torch.topk(score, 2, dim=-1).values
            gap = (top2[:, 0] - top2[:, 1]).numpy()
            assert (gap[(t_got != t_want).numpy()] <= MARGIN).all(), gap
            break
        held += 1
    if held == len(jcalls):
        assert [q.out_tokens for q in treqs] == [q.out_tokens for q in jreqs]
