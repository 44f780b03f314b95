"""The LM serving path (``repro_torch.models``, ``repro_torch.serve.engine``) on
the card against ``device="cpu"`` (``cuda`` marker).

Every test skips where ``torch.cuda.is_available()`` is False.  The file
imports neither JAX nor the reference package, so it runs on the machine
with the card:

    python -m pytest -q -p no:cacheprovider tests/test_torch_cuda_lm.py

The CPU side is held against the JAX reference by ``tests/test_torch_lm_*.py``.
Tolerances: cuBLAS and the CPU's GEMM sum the products of every bf16 matmul
in other orders, so activations differ by bf16 ulps: layers and logits within
ATOL + RTOL * |x| (the decode bound of ``tests/models/test_smoke_archs.py``);
masks, caches' positions, and the gate given the same logits and key (token,
confidence, accept flag, ``bayes_decide`` counts) bit for bit.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import prng
from repro_torch.kernels import bayes_decide
from repro_torch.kernels.bayes_decide import kernel as BK
from repro_torch.models import api, bayes_head, layers, transformer
from repro_torch.serve import EngineConfig, Request, ServeEngine
from repro_torch.serve import engine as tengine

torch.set_num_threads(1)

ATOL, RTOL = 1e-1, 2e-2
ARCHS = ["qwen2-72b", "starcoder2-15b", "minitron-4b", "phi3-mini-3.8b", "internvl2-26b"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _close(got, want):
    assert got.device.type == "cuda"
    got, want = got.float().cpu(), want.float()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def _bf(gen, shape, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["causal", "local", "chunk", "full_bidir"])
def test_attention_and_masks_card_against_cpu(cuda_device, kind):
    g = torch.Generator().manual_seed(1)
    q, k, v = _bf(g, (2, 21, 4, 16)), _bf(g, (2, 21, 2, 16)), _bf(g, (2, 21, 2, 16))
    pos = torch.arange(21) + 3
    kw = dict(kind=kind, window=5, chunk=8, q_chunk=8)
    want = layers.multihead_attention(q, k, v, q_positions=pos, k_positions=pos, **kw)
    got = layers.multihead_attention(q.cuda(), k.cuda(), v.cuda(), q_positions=pos.cuda(),
                                     k_positions=pos.cuda(), **kw)
    _close(got, want)
    assert torch.equal(layers._mask_bias(kind, pos.cuda(), pos.cuda(), 5, 8).cpu(),
                       layers._mask_bias(kind, pos, pos, 5, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "relu2", "none"])
def test_norms_rope_and_mlps_card_against_cpu(cuda_device, kind):
    g = torch.Generator().manual_seed(2)
    x = _bf(g, (2, 12, 64))
    p = {"wi": _bf(g, (64, 128), 0.125), "wg": _bf(g, (64, 128), 0.125),
         "wo": _bf(g, (128, 64), 0.09)}
    _close(layers.apply_mlp({n: t.cuda() for n, t in p.items()}, x.cuda(), kind),
           layers.apply_mlp(p, x, kind))
    for norm in ("rmsnorm", "layernorm"):
        np_ = {"scale": torch.randn(64, generator=g), "bias": torch.randn(64, generator=g)}
        _close(layers.apply_norm({n: t.cuda() for n, t in np_.items()}, x.cuda(), norm),
               layers.apply_norm(np_, x, norm))
    xr = _bf(g, (2, 9, 4, 16))
    pos = torch.arange(9) + 70_000
    _close(layers.apply_rope(xr.cuda(), pos.cuda(), 1e6), layers.apply_rope(xr, pos, 1e6))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_arch_card_against_cpu(cuda_device, arch):
    """Init on the card (the same draws as on the CPU but where a bf16 rounding
    falls apart), the weights copied to the CPU; forward, prefill and decode."""
    cfg = get_smoke_config(arch)
    card = api.init(cfg, prng.PRNGKey(0), device="cuda")
    own_cpu = api.init(cfg, prng.PRNGKey(0), device="cpu")
    for (n, a), (m, b) in zip(card.named_parameters(), own_cpu.named_parameters()):
        assert n == m and a.dtype == b.dtype
        assert float((a.cpu() != b).float().mean()) <= 1e-3, n
    cpu = copy.deepcopy(card).to("cpu")
    gen = np.random.default_rng(3)
    toks = torch.from_numpy(gen.integers(0, cfg.vocab_size, (2, 12)))
    extra = None
    if cfg.frontend == "patch":
        extra = torch.from_numpy(gen.standard_normal((2, 4, cfg.d_model)).astype(np.float32))
    n_extra = 0 if extra is None else 4
    out = {}
    with torch.inference_mode():
        for dev, model in (("cpu", cpu), ("cuda", card)):
            t = toks.to(dev)
            e = None if extra is None else extra.to(dev)
            fw, _ = transformer.forward(model, cfg, t, e)
            batch = {"tokens": t[:, :-1]} | ({} if e is None else {"extra_embeds": e})
            lp, st = api.prefill(model, cfg, batch, 16 + n_extra)
            ld, st = api.decode(model, cfg, t[:, -1], st, 11 + n_extra)
            out[dev] = (fw, lp, ld, st["blocks"][0][0]["pos"])
    for a, b in zip(out["cuda"][:3], out["cpu"][:3]):
        _close(a, b)
    assert torch.equal(out["cuda"][3].cpu(), out["cpu"][3])


@pytest.mark.cuda
def test_every_attention_block_kind_card_against_cpu(cuda_device):
    """attn_local, attn_chunk, attn and attn_global in one stack; decode steps
    roll past the bounded caches of the local and chunked layers."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-72b"), num_layers=4, window=6, chunk=4,
                              pattern=("attn_local", "attn_chunk", "attn", "attn_global"))
    card = api.init(cfg, prng.PRNGKey(1), device="cuda")
    cpu = copy.deepcopy(card).to("cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 14)))
    with torch.inference_mode():
        a, sa = api.prefill(card, cfg, {"tokens": toks[:, :5].cuda()}, 16)
        b, sb = api.prefill(cpu, cfg, {"tokens": toks[:, :5]}, 16)
        _close(a, b)
        for pos in range(5, 14):
            a, sa = api.decode(card, cfg, toks[:, pos].cuda(), sa, pos)
            b, sb = api.decode(cpu, cfg, toks[:, pos], sb, pos)
            _close(a, b)
            for i in range(4):
                assert torch.equal(sa["blocks"][i][0]["pos"].cpu(), sb["blocks"][i][0]["pos"])


@pytest.mark.cuda
def test_engine_run_with_the_stochastic_gate(cuda_device, monkeypatch):
    """A whole serve on the card: bayes_decide launches once per step; the gate
    on the CPU's logits gives the CPU's decisions bit for bit on the card."""
    cfg = get_smoke_config("qwen2-72b")
    ecfg = EngineConfig(max_batch=3, t_cache=64, stochastic_gate=True, gate_n_bits=256)
    calls, real = [], tengine.emission_gate

    def gate(e, key, logits, *, device="cuda"):
        calls.append((np.asarray(key), logits.detach().cpu()))
        return real(e, key, logits, device=device)
    monkeypatch.setattr(tengine, "emission_gate", gate)
    model = api.init(cfg, prng.PRNGKey(0), device="cuda")
    r = np.random.default_rng(5)
    reqs = [Request(rid=i, prompt=r.integers(0, cfg.vocab_size, size=5 + 2 * i).astype(np.int32),
                    max_new_tokens=6 + i) for i in range(5)]
    before = BK.bayes_decide_cuda.launches
    ServeEngine(cfg, model, ecfg, device="cuda").run(prng.PRNGKey(7), reqs)
    torch.cuda.synchronize()
    assert BK.bayes_decide_cuda.launches - before == len(calls) > 0
    assert all(q.done and len(q.out_tokens) == q.max_new_tokens for q in reqs)
    for key, logits in calls:
        a = [t.cpu() for t in real(ecfg, key, logits.cuda(), device="cuda")]
        b = real(ecfg, key, logits, device="cpu")
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        temp = torch.full((), ecfg.ensemble_temp)
        _, p = bayes_head._candidates(torch.stack([logits, logits / temp]), 8, "cpu")
        kb, kc = bayes_decide(key, p.cuda(), 256, device="cuda")
        pb, pc = bayes_decide(key, p, 256, device="cpu")
        assert torch.equal(kb.cpu(), pb) and torch.equal(kc.cpu(), pc)
