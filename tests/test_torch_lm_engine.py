"""The port's ServeEngine (``repro_torch.serve.engine``): mirrors of
``tests/serve/test_engine.py`` and ``tests/obs/test_engine_obs.py``, run on the
port at the same smoke config, and a whole ``run`` held against the
reference's engine with the same weights, requests and key.

Tolerances of the parity test:

* the logits each engine feeds its gate: within LOGIT_ATOL + LOGIT_RTOL * |x|
  (the model tests' tolerance: the compiled reference keeps some bf16
  intermediates in float32);
* the gate, given the same logits and key: token, accept flag and, for the
  stochastic gate, the confidence (a ratio of ``bayes_decide`` counts) bit for
  bit; the analytic gate's confidence within ``fused_analytic``'s atol 2e-6,
  rtol 1e-5;
* the emitted tokens: equal at every step until the first step whose tokens
  differ at a near tie of the gate on the reference's logits -- a top-2 gap
  of the fused candidate posteriors under MARGIN, or of the stochastic gate's
  counts of at most COUNT_MARGIN of its 256 bits -- where the two contexts
  part and the comparison ends.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import api as japi
from repro.models import bayes_head as jbayes_head
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core import prng
from repro_torch.kernels import bayes_decide
from repro_torch.models import api, bayes_head, convert
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serve import EngineConfig, Request, ServeEngine
from repro_torch.serve import engine as tengine

torch.set_num_threads(1)

LOGIT_ATOL, LOGIT_RTOL = 1e-1, 2e-2
FUSED_ATOL, FUSED_RTOL = 2e-6, 1e-5
MARGIN = 1e-2
COUNT_MARGIN = 8


@pytest.fixture(scope="module")
def engine_setup():
    cfg = get_smoke_config("qwen2-72b")
    params = api.init(cfg, prng.PRNGKey(0), device="cpu")
    return cfg, params


def _engine(setup, **kw):
    cfg, params = setup
    return ServeEngine(cfg, params, EngineConfig(**kw), device="cpu")


# --- mirrors of tests/serve/test_engine.py --------------------------------------------

def test_engine_serves_batch(engine_setup):
    cfg, _ = engine_setup
    eng = _engine(engine_setup, max_batch=3, t_cache=64)
    reqs = [Request(rid=i, prompt=np.arange(4 + i) % cfg.vocab_size, max_new_tokens=6)
            for i in range(3)]
    out = eng.run(prng.PRNGKey(1), reqs)
    for r in out:
        assert len(r.out_tokens) == 6
        assert all(0 <= t < cfg.vocab_size + 256 for t in r.out_tokens)
        assert all(0.0 <= c <= 1.0 for c in r.confidences)
        assert r.done


def test_engine_frees_slots(engine_setup):
    eng = _engine(engine_setup, max_batch=2, t_cache=64)
    reqs = [Request(rid=0, prompt=np.arange(4), max_new_tokens=2),
            Request(rid=1, prompt=np.arange(5), max_new_tokens=2)]
    eng.run(prng.PRNGKey(0), reqs)
    assert all(s is None for s in eng.slots)


def test_pending_queue_admits_as_slots_free(engine_setup):
    eng = _engine(engine_setup, max_batch=2, t_cache=64)
    reqs = [Request(rid=0, prompt=np.arange(4), max_new_tokens=8),
            Request(rid=1, prompt=np.arange(5), max_new_tokens=2),
            Request(rid=2, prompt=np.arange(3), max_new_tokens=2),
            Request(rid=3, prompt=np.arange(4), max_new_tokens=2)]
    eng.add_requests(reqs)
    assert eng.pending and len([s for s in eng.slots if s is not None]) == 2
    eng.run(prng.PRNGKey(0), [])
    for r in reqs:
        assert r.done and len(r.out_tokens) == r.max_new_tokens, r.rid
    assert not eng.pending and all(s is None for s in eng.slots)
    assert reqs[2].admit_step == 2, reqs[2].admit_step
    assert reqs[3].admit_step == 4, reqs[3].admit_step


def test_pending_queue_churn_preserves_order_and_never_starves(engine_setup):
    eng = _engine(engine_setup, max_batch=2, t_cache=96)
    waves = [[Request(rid=10 * w + i, prompt=np.arange(3 + i), max_new_tokens=1 + (i % 3))
              for i in range(3)] for w in range(3)]
    submitted = []
    eng.add_requests(waves[0])
    submitted += waves[0]
    logits = eng.prefill_all()
    key = prng.PRNGKey(4)
    steps = 0
    while any(s is not None for s in eng.slots) or eng.pending:
        if steps == 2:
            eng.add_requests(waves[1])
            submitted += waves[1]
        if steps == 4:
            eng.add_requests(waves[2])
            submitted += waves[2]
        key, sub = prng.split(key)
        logits, _ = eng.step(sub, logits)
        steps += 1
        assert steps < 100, "engine churn did not converge -- starvation"
    for r in submitted:
        assert r.done and len(r.out_tokens) == r.max_new_tokens, r.rid
        assert r.admit_step >= 0, f"rid {r.rid} was never admitted"
    admit_steps = [r.admit_step for r in submitted]
    assert admit_steps == sorted(admit_steps), admit_steps


def test_midflight_add_requests_gets_prefilled(engine_setup):
    eng = _engine(engine_setup, max_batch=2, t_cache=64)
    r0 = Request(rid=0, prompt=np.arange(4), max_new_tokens=6)
    eng.add_requests([r0])
    logits = eng.prefill_all()
    key, sub = prng.split(prng.PRNGKey(0))
    logits, _ = eng.step(sub, logits)
    late = Request(rid=1, prompt=np.arange(5), max_new_tokens=3)
    eng.add_requests([late])
    assert eng.pending and late.admit_step == -1
    while any(s is not None for s in eng.slots) or eng.pending:
        key, sub = prng.split(key)
        logits, _ = eng.step(sub, logits)
    assert late.admit_step == 2 and late.done
    assert len(late.out_tokens) == 3 and len(r0.out_tokens) == 6


def test_bayes_gate_vs_greedy(engine_setup):
    eng = _engine(engine_setup, max_batch=1, t_cache=64, bayes_gate=False)
    r = Request(rid=0, prompt=np.arange(6), max_new_tokens=4)
    eng.run(prng.PRNGKey(0), [r])
    assert len(r.out_tokens) == 4


def test_fuse_posteriors_sharpens():
    logits = torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(2), (1, 3, 64))) * 2.0)
    sources = torch.stack([logits[0], logits[0] * 0.9], dim=0)
    token, conf, fused = bayes_head.fuse_posteriors(sources, top_k=8, device="cpu")
    single = torch.softmax(logits[0], -1).amax(-1)
    assert float(conf[0]) >= float(single[0]) - 0.05
    np.testing.assert_allclose(fused.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_fuse_posteriors_stochastic_matches_analytic():
    logits = torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(3), (2, 4, 32))) * 1.5)
    t_a, c_a, _ = bayes_head.fuse_posteriors(logits, top_k=4, device="cpu")
    t_s, c_s = bayes_head.fuse_posteriors_stochastic(prng.PRNGKey(9), logits, top_k=4,
                                                     n_bits=1 << 13, device="cpu")
    assert int((t_a == t_s).sum()) >= 3, (t_a, t_s)
    np.testing.assert_allclose(c_a.numpy(), c_s.numpy(), atol=0.08)


def test_reliable_decision_gate():
    ok, tok = bayes_head.reliable_decision(torch.tensor([1, 2]), torch.tensor([0.9, 0.3]),
                                           threshold=0.7)
    assert bool(ok[0]) and not bool(ok[1])


# --- mirrors of tests/obs/test_engine_obs.py ------------------------------------------

def _reqs(n, tokens=2):
    return [Request(rid=i, prompt=np.arange(4), max_new_tokens=tokens) for i in range(n)]


def test_admission_counters_and_gauges(engine_setup):
    cfg, params = engine_setup
    mx, tr = MetricsRegistry(), Tracer()
    eng = ServeEngine(cfg, params, EngineConfig(max_batch=2, t_cache=64), trace=tr, metrics=mx,
                      device="cpu")
    eng.add_requests(_reqs(4))
    assert mx.count("requests_in") == 4
    assert mx.count("requests_admitted") == 2
    assert mx.gauges["pending_depth"] == 2
    assert mx.gauges["active_slots"] == 2
    eng.run(prng.PRNGKey(0), [])
    assert mx.count("requests_admitted") == 4
    assert mx.count("requests_done") == 4
    assert mx.count("tokens_out") == 4 * 2
    assert mx.gauges["pending_depth"] == 0
    assert mx.gauges["active_slots"] == 0
    assert mx.count("prefills") >= 1


def test_step_and_prefill_spans(engine_setup):
    cfg, params = engine_setup
    tr = Tracer()
    eng = ServeEngine(cfg, params, EngineConfig(max_batch=2, t_cache=64), trace=tr,
                      metrics=MetricsRegistry(), device="cpu")
    eng.run(prng.PRNGKey(0), _reqs(2))
    assert len(tr.named("engine.prefill")) >= 1
    steps = tr.named("engine.step")
    assert len(steps) >= 2
    assert steps[0].attrs["step"] == 0
    assert all(s.done for s in tr.spans)


def test_untraced_engine_unchanged(engine_setup):
    eng = _engine(engine_setup, max_batch=2, t_cache=64)
    assert eng.trace is None and eng.metrics is None
    out = eng.run(prng.PRNGKey(0), _reqs(2))
    assert all(r.done for r in out)


# --- the port's engine against the reference's ----------------------------------------

_BOTH = {}


def _both_models(arch):
    """(reference config, reference params as numpy, config, the port's model
    from the same params), once per arch."""
    if arch not in _BOTH:
        ref = jax.tree.map(np.asarray, japi.init(jsmoke(arch), jax.random.PRNGKey(0)))
        _BOTH[arch] = (jsmoke(arch), ref, get_smoke_config(arch),
                       convert.params_from_reference(ref, get_smoke_config(arch), device="cpu"))
    return _BOTH[arch]


def _record_port(monkeypatch):
    """Every gate call of the port's engines: (key, logits, token, conf, ok)."""
    calls, real = [], tengine.emission_gate

    def gate(ecfg, key, logits, *, device="cuda"):
        out = real(ecfg, key, logits, device=device)
        calls.append((np.asarray(key), *(t.detach().cpu().numpy() for t in (logits, *out))))
        return out
    monkeypatch.setattr(tengine, "emission_gate", gate)
    return calls


def _record_reference(monkeypatch):
    """Every step of the reference's engines: (key, the logits its gate takes)."""
    calls, real = [], JServeEngine._step_impl

    def step_impl(eng, key, last_logits):
        calls.append((np.asarray(key), np.asarray(last_logits)))
        return real(eng, key, last_logits)
    monkeypatch.setattr(JServeEngine, "_step_impl", step_impl)
    return calls


def _reference_gate(ecfg, key, logits):
    """The reference engine's gate (engine.py:165-184) on numpy logits."""
    last = jnp.asarray(logits)
    sources = jnp.stack([last, last / ecfg.ensemble_temp], axis=0)
    if ecfg.stochastic_gate:
        token, conf = jbayes_head.fuse_posteriors_stochastic(
            jnp.asarray(key), sources, top_k=8, n_bits=ecfg.gate_n_bits)
    else:
        token, conf, _ = jbayes_head.fuse_posteriors(sources, top_k=8)
    ok, token = jbayes_head.reliable_decision(token, conf, ecfg.confidence_threshold)
    return np.asarray(token), np.asarray(conf), np.asarray(ok)


def _decision_gap(ecfg, key, logits):
    """Per row, the gap between the gate's best and second candidate: fused
    posteriors (analytic) or ``bayes_decide`` counts (stochastic)."""
    lg = torch.from_numpy(logits.copy())
    src = torch.stack([lg, lg / torch.full((), ecfg.ensemble_temp)])
    if ecfg.stochastic_gate:
        _, p = bayes_head._candidates(src, 8, "cpu")
        score = bayes_decide(key, p, ecfg.gate_n_bits, device="cpu")[1].float()
    else:
        score = bayes_head.fuse_posteriors(src, top_k=8, device="cpu")[2]
    top2 = torch.topk(score, 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).numpy()


def _requests(cls, vocab):
    r = np.random.default_rng(5)
    return [cls(rid=i, prompt=r.integers(0, vocab, size=5 + 2 * i).astype(np.int32),
                max_new_tokens=6 + i) for i in range(5)]


@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("arch,op_by_op", [("qwen2-72b", False), ("minitron-4b", True)])
def test_run_matches_the_reference_engine(monkeypatch, arch, op_by_op, stochastic):
    """A whole run: 5 requests on 3 slots (two admitted mid-flight).  Against
    the compiled reference (smoke qwen2-72b) the runs part at the first near
    tie; against the reference run op by op (``jax.disable_jit``) on the arch
    with no silu/gelu the logits agree to a bf16 ulp and the whole run is held:
    every token, confidence and admission step equal."""
    jcfg, ref, cfg, model = _both_models(arch)
    kw = dict(max_batch=3, t_cache=64, stochastic_gate=stochastic, gate_n_bits=256)
    jcalls = _record_reference(monkeypatch)
    jreqs = _requests(JRequest, cfg.vocab_size)
    jengine = JServeEngine(jcfg, jax.tree.map(jnp.asarray, ref), JEngineConfig(**kw))
    if op_by_op:
        with jax.disable_jit():
            jengine.run(jax.random.PRNGKey(7), jreqs)
    else:
        jengine.run(jax.random.PRNGKey(7), jreqs)
    tcalls = _record_port(monkeypatch)
    treqs = _requests(Request, cfg.vocab_size)
    ServeEngine(cfg, model, EngineConfig(**kw), device="cpu").run(prng.PRNGKey(7), treqs)
    assert len(tcalls) == len(jcalls)
    ecfg = EngineConfig(**kw)
    held = 0
    for (jkey, jlogits), (tkey, tlogits, ttok, tconf, tok) in zip(jcalls, tcalls):
        np.testing.assert_array_equal(tkey, jkey)                       # the same key per step
        np.testing.assert_allclose(tlogits, jlogits, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
        # the gate through the same logits
        want = _reference_gate(ecfg, jkey, jlogits)
        got = [t.numpy() for t in tengine.emission_gate(ecfg, jkey, torch.from_numpy(jlogits.copy()),
                                                         device="cpu")]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[2], want[2])
        if stochastic:       # counts / total: bit for bit
            np.testing.assert_array_equal(got[1], want[1])
        else:                # eq (5) in float32: fused_analytic's tolerance
            np.testing.assert_allclose(got[1], want[1], atol=FUSED_ATOL, rtol=FUSED_RTOL)
        if not np.array_equal(ttok, want[0]):
            # the engines part only at a near tie of the gate's decision
            gap = _decision_gap(ecfg, jkey, jlogits)
            assert (gap[ttok != want[0]] <= (COUNT_MARGIN if stochastic else MARGIN)).all(), gap
            break
        held += 1
    if op_by_op:
        assert held == len(jcalls)
    if held == len(jcalls):
        assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
        assert [r.admit_step for r in treqs] == [r.admit_step for r in jreqs]
        got = np.concatenate([r.confidences for r in treqs])
        want = np.concatenate([r.confidences for r in jreqs])
        if stochastic:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=FUSED_ATOL, rtol=FUSED_RTOL)


def test_stochastic_gate_counts_equal_reference_through_the_same_logits():
    """bayes_decide's counts behind the stochastic gate, on bf16-valued logits
    with ties among the candidates (the candidates in lax.top_k's order)."""
    from repro.kernels.bayes_decide.ops import bayes_decide as jbayes_decide
    cfg = get_smoke_config("qwen2-72b")
    r = np.random.default_rng(6)
    logits = (r.standard_normal((6, cfg.vocab_size + 256)) * 2).astype(np.float32)
    logits = torch.from_numpy(logits).bfloat16().float().numpy()           # bf16 ties
    logits[:, 10:14] = logits[:, 3:4]                                      # exact ties at the top
    logits[:, 3] += 9.0
    key = jax.random.PRNGKey(12)
    last = jnp.asarray(logits)
    src = jnp.stack([last, last / 1.3], axis=0)
    _, cand = jax.lax.top_k(jnp.mean(src, axis=0), 8)
    p = jax.nn.softmax(jnp.take_along_axis(src, cand[None].repeat(2, 0), axis=-1), axis=-1)
    want_best, want_counts = jbayes_decide(key, p, 256)
    tl = torch.from_numpy(logits)
    tcand, tp = bayes_head._candidates(torch.stack([tl, tl / torch.full((), 1.3)]), 8, "cpu")
    np.testing.assert_array_equal(tcand.numpy(), np.asarray(cand))
    got_best, got_counts = bayes_decide(np.asarray(key), tp, 256, device="cpu")
    np.testing.assert_array_equal(got_counts.numpy(), np.asarray(want_counts))
    np.testing.assert_array_equal(got_best.numpy(), np.asarray(want_best))


def test_launcher_and_example_match_the_references(capsys, monkeypatch):
    """The port's launcher serves what it is asked; its serve_lm example prints
    what the reference's script prints."""
    import pathlib
    import runpy

    from repro_torch.examples import serve_lm
    from repro_torch.launch import serve as tserve
    reqs = tserve.main(["--arch", "phi3-mini-3.8b", "--smoke", "--requests", "3",
                        "--new-tokens", "4", "--stochastic-gate", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3 and all(len(r.out_tokens) == 4 for r in reqs)
    assert all(0.0 <= c <= 1.0 for r in reqs for c in r.confidences)
    with pytest.raises(SystemExit):
        tserve.main(["--gate-bits", "100", "--device", "cpu"])
    capsys.readouterr()
    serve_lm.main("cpu")
    mine = capsys.readouterr().out
    runpy.run_path(str(pathlib.Path(__file__).parents[1] / "examples" / "serve_lm.py"),
                   run_name="__main__")
    assert mine == capsys.readouterr().out
