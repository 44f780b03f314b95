"""The training stack (``repro_torch.{optim,data,checkpoint,train}``) on the
card against ``device="cpu"`` (``cuda`` marker), at smoke size.

Every test skips where ``torch.cuda.is_available()`` is False.  The file
imports neither JAX nor the reference package, so it runs on the machine
with the card:

    python -m pytest -q -p no:cacheprovider tests/test_torch_cuda_train.py

The CPU side is held against the JAX reference by
``tests/test_torch_train_*.py``.  Tolerances:

* AdamW on the same gradients: the elementwise update is IEEE arithmetic on
  both devices, the square roots correctly rounded (float64); the global
  norm sums in float64 in another order and torch's ``cos``/``pow`` may round
  the schedule and the bias corrections differently by an ulp, so ``m``,
  ``v`` and ``master`` within LEAF_REL of each leaf's largest value and the
  bf16 params within one ulp;
* compression: ``device_uniform`` on the card is the host's ``uniform`` bit
  for bit, and so are the int8 values, scales and residuals;
* ``batch_at_step``: tokens bit for bit, ``extra_embeds`` within NORMAL_ULP
  (the platforms' ``log1p``);
* one train step: cuBLAS and the CPU's GEMM sum bf16 products in other
  orders, so the gradients differ by bf16 ulps; the loss within LOSS_ATOL,
  and the first step moves a weight by about ``lr`` times its gradient's
  sign, so the new params within one bf16 ulp but for at most FLIP_SHARE of
  them (gradients near zero), and all within 2 lr.
"""

import copy

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.core import prng
from repro_torch.data import DataConfig, batch_at_step
from repro_torch.models import api
from repro_torch.optim import AdamWConfig, adamw, compression
from repro_torch.train import TrainConfig, TrainLoop, make_train_step

torch.set_num_threads(1)

LEAF_REL = 1e-6
NORMAL_ULP = 4
LOSS_ATOL = 2e-2
FLIP_SHARE = 2e-2
BF16_ULP = 2.0 ** -7
ARCHS = ["qwen2-72b", "phi3-mini-3.8b", "llama4-scout-17b-a16e"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _leaf_rel(got, want):
    got, want = got.float().cpu(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _grads(model, seed):
    gen = torch.Generator().manual_seed(seed)
    return {n: (torch.randn(p.shape, generator=gen) * 0.05).to(p.dtype)
            for n, p in model.named_parameters()}


@pytest.mark.cuda
def test_adamw_card_against_cpu(cuda_device):
    cfg = get_smoke_config("qwen2-72b")
    cpu = api.init(cfg, prng.PRNGKey(0), device="cpu")
    card = copy.deepcopy(cpu).to(cuda_device)
    opt = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    states = {"cpu": adamw.init(cpu), "cuda": adamw.init(card)}
    for step in range(3):
        g = _grads(cpu, step)
        new_cpu, states["cpu"], m_cpu = adamw.apply({k: v.clone() for k, v in g.items()},
                                                    states["cpu"], opt)
        new_card, states["cuda"], m_card = adamw.apply(
            {k: v.to(cuda_device) for k, v in g.items()}, states["cuda"], opt)
        assert m_card["grad_norm"].item() == pytest.approx(m_cpu["grad_norm"].item(), rel=1e-6)
        assert m_card["lr"].item() == pytest.approx(m_cpu["lr"].item(), rel=2.0 ** -22)
    assert states["cuda"].step.device.type == "cuda" and int(states["cuda"].step) == 3
    for field in ("master", "m", "v"):
        for k, want in getattr(states["cpu"], field).items():
            assert _leaf_rel(getattr(states["cuda"], field)[k], want) <= LEAF_REL, (field, k)
    for k, want in new_cpu.items():
        got = new_card[k]
        assert got.device.type == "cuda" and got.dtype == want.dtype
        torch.testing.assert_close(got.cpu().float(), want.float(), atol=1e-6,
                                   rtol=BF16_ULP if want.dtype == torch.bfloat16 else 1e-5)


@pytest.mark.cuda
def test_compression_card_against_cpu(cuda_device):
    cfg = get_smoke_config("llama4-scout-17b-a16e")      # stacked repetitions and MoE leaves
    model = api.init(cfg, prng.PRNGKey(0), device="cpu")
    g = {k: v.float() for k, v in _grads(model, 7).items()}
    r = {k: v * 1e-3 for k, v in _grads(model, 8).items()}
    key = prng.PRNGKey(9)
    want = compression.compress(key, g, r)
    got = compression.compress(key, {k: v.to(cuda_device) for k, v in g.items()},
                               {k: v.to(cuda_device) for k, v in r.items()})
    for w_tree, g_tree in zip(want, got):
        for k in w_tree:
            assert g_tree[k].device.type == "cuda"
            assert torch.equal(g_tree[k].cpu(), w_tree[k]), k
    u_card = prng.device_uniform(key, (3, 5, 7), device=cuda_device)
    assert torch.equal(u_card.cpu(), torch.from_numpy(prng.uniform(key, (3, 5, 7))))


@pytest.mark.cuda
@pytest.mark.parametrize("frontend", ["none", "patch"])
def test_batch_at_step_card_against_cpu(cuda_device, frontend):
    cfg = DataConfig(seed=3, global_batch=8, seq_len=128, vocab_size=32_064, frontend=frontend,
                     n_extra=4, d_model=64)
    for step in (0, 9):
        cpu, card = batch_at_step(cfg, step, device="cpu"), batch_at_step(cfg, step)
        assert set(cpu) == set(card)
        for k in ("tokens", "labels"):
            assert card[k].device.type == "cuda" and torch.equal(card[k].cpu(), cpu[k])
        if frontend == "patch":
            a = card["extra_embeds"].cpu().view(torch.int32).long()
            b = cpu["extra_embeds"].view(torch.int32).long()
            assert int((a - b).abs().max()) <= NORMAL_ULP


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_card_against_cpu(cuda_device, arch):
    cfg = get_smoke_config(arch)
    card = api.init(cfg, prng.PRNGKey(0), device=cuda_device)
    cpu = copy.deepcopy(card).to("cpu")
    opt = AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=10)
    data = DataConfig(seed=1, global_batch=4, seq_len=16, vocab_size=cfg.vocab_size)
    out = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        out[dev] = make_train_step(cfg, opt)(model, adamw.init(model),
                                             batch_at_step(data, 0, device=dev))
    (pc, sc, mc), (pg, sg, mg) = out["cpu"], out["cuda"]
    assert abs(mg["loss"].item() - mc["loss"].item()) <= LOSS_ATOL
    flips = total = 0
    for (n, a), (_, b) in zip(pg.named_parameters(), pc.named_parameters()):
        assert a.device.type == "cuda" and a.dtype == b.dtype, n
        diff = (a.detach().cpu().float() - b.detach().float()).abs()
        flips += int((diff > BF16_ULP * b.detach().float().abs() + 1e-30).sum())
        total += diff.numel()
        assert float(diff.max()) <= 2 * opt.lr * 1.01 + BF16_ULP * float(b.detach().abs().max()), n
    assert flips <= FLIP_SHARE * total, (flips, total)


@pytest.mark.cuda
def test_train_loop_on_the_card_resumes_and_restores_to_the_cpu(cuda_device, tmp_path):
    cfg = get_smoke_config("qwen2-72b")
    data = DataConfig(seed=1, global_batch=8, seq_len=32, vocab_size=cfg.vocab_size)
    opt = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=6)
    tc = TrainConfig(steps=6, ckpt_every=3, ckpt_dir=str(tmp_path / "a"))
    loop = TrainLoop(cfg, data, tc, opt)
    params, state, hist = loop.run(prng.PRNGKey(0))
    assert [h["step"] for h in hist] == list(range(6)) and all(np.isfinite(h["loss"]) for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert loop.ckpt.available_steps() == [3, 6]
    # the card's checkpoint restores into a template on the CPU, equal to the card's state
    cpu_model = api.init(cfg, prng.PRNGKey(1), device="cpu")
    _, (cpu_params, cpu_state) = Checkpointer(str(tmp_path / "a")).restore(
        (cpu_model, adamw.init(cpu_model)))
    for (n, a), (_, b) in zip(params.named_parameters(), cpu_params.named_parameters()):
        assert torch.equal(a.cpu(), b), n
    for k in state.master:
        assert torch.equal(state.master[k].cpu(), cpu_state.master[k])
    # a second loop resumes from step 6: nothing left to run
    _, _, hist2 = TrainLoop(cfg, data, tc, opt).run(prng.PRNGKey(0))
    assert hist2 == []
