"""The port's fusion-operator CUDA kernels on the card (``cuda`` marker).

Needs an NVIDIA GPU with ``nvcc``; every test skips where
``torch.cuda.is_available()`` is False.  The file imports neither JAX nor the
reference package, so it runs on the machine with the card:

    python -m pytest -q -p no:cacheprovider tests/test_torch_cuda_operators.py

Each kernel is held against its plain torch version, which
``test_torch_operators.py`` holds against the JAX reference on the CPU: bit
for bit for the integer kernels, within atol 2e-6, rtol 1e-5 for
``fusion_map`` (the card's logf/expf and the CPU's log/exp may differ in the
last bits).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import rng
from repro_torch.kernels import bayes_decide, bayes_decide_packed, fusion_map
from repro_torch.kernels import pand_popcount, sne_encode
from repro_torch.kernels.bayes_decide import kernel as BK
from repro_torch.kernels.bayes_decide.ref import bayes_decide_ref
from repro_torch.kernels.fusion_map import kernel as FK
from repro_torch.kernels.pand_popcount import kernel as PK
from repro_torch.kernels.sne_encode import kernel as SK
from repro_torch.kernels.sne_encode.ref import sne_encode_ref
from repro_torch.models import bayes_head

torch.set_num_threads(1)

KD = np.array([0x9E3779B9, 0x12345678], np.uint32)
WRAP = 2**32 - 1000        # counters of these draws wrap 2**32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _probs(seed, shape):
    r = np.random.default_rng(seed)
    p = r.random(shape).astype(np.float32)
    flat = p.reshape(-1)
    flat[: min(flat.size, 7)] = np.array([0.0, 1.0, 1.5, -0.2, 1 / 512, 3 / 512, 511 / 512],
                                         np.float32)[: min(flat.size, 7)]
    if p.ndim == 3:
        p[:, 1] = 0.0           # a row where every class ties at count 0
    return p


# (M, rows not a multiple of the block, K, n_bits, counter origin)
_CASES = [(1, 300, 2, 64, 0), (2, 4099, 16, 128, 0), (3, 257, 5, 96, WRAP),
          (2, 1000, 2, 256, WRAP), (3, 33, 1, 32, 2**32 + 5)]
_IDS = [f"M{c[0]}-R{c[1]}-K{c[2]}-{c[3]}b-off{c[4]}" for c in _CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _CASES, ids=_IDS)
def test_integer_kernels_equal_plain_versions(case, cuda_device):
    m, r, k, n_bits, offset = case
    p = torch.from_numpy(_probs(r + k, (m, r, k)))
    kd0, kd1 = (int(v) for v in KD)
    pc = p.to(cuda_device)
    words = SK.sne_encode_cuda(kd0, kd1, pc.reshape(-1), n_bits=n_bits, offset=offset)
    counts = PK.pand_popcount_cuda(words.view(m, r * k, -1))
    dec, cnt = BK.bayes_decide_cuda(kd0, kd1, pc, n_bits=n_bits, offset=offset)
    torch.cuda.synchronize()
    rand = rng.counter_hash_words(KD, (m, r, k), n_bits // 4, offset=offset)
    want_words = sne_encode_ref(p.reshape(-1), rand.view(m * r * k, -1))
    want_dec, want_cnt = bayes_decide_ref(p, rand)
    for got, want in ((words, want_words), (counts, want_cnt.view(-1)), (cnt, want_cnt),
                      (dec, want_dec)):
        assert got.device.type == "cuda" and got.dtype == want.dtype
        assert torch.equal(got.cpu(), want)
    assert int(dec[1]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", _CASES[:3], ids=_IDS[:3])
def test_entry_points_launch_the_kernels(case, cuda_device):
    m, r, k, n_bits, _ = case
    p = _probs(r + k, (m, r, k))
    before = (SK.sne_encode_cuda.launches, PK.pand_popcount_cuda.launches,
              BK.bayes_decide_cuda.launches)
    counts = pand_popcount(sne_encode(KD, p, n_bits, device=cuda_device), device=cuda_device)
    dec, cnt = bayes_decide(KD, p, n_bits, device=cuda_device)
    dec_p, cnt_p = bayes_decide_packed(KD, p, n_bits, device=cuda_device)
    torch.cuda.synchronize()
    assert (SK.sne_encode_cuda.launches, PK.pand_popcount_cuda.launches,
            BK.bayes_decide_cuda.launches) == (before[0] + 2, before[1] + 2, before[2] + 1)
    want_dec, want_cnt = bayes_decide(KD, p, n_bits, device="cpu")
    for got, want in ((counts, want_cnt), (cnt, want_cnt), (dec, want_dec),
                      (cnt_p, want_cnt), (dec_p, want_dec)):
        assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("m,r,k", [(1, 300, 2), (2, 4099, 16), (3, 257, 5)])
@pytest.mark.parametrize("uniform", [False, True])
def test_fusion_map_kernel_within_tolerance(m, r, k, uniform, cuda_device):
    rs = np.random.default_rng(m + r + k)
    p = rs.dirichlet(np.ones(k), size=(m, r)).astype(np.float32)
    p[:, 0] = 0.0
    prior = None if uniform else rs.dirichlet(np.ones(k)).astype(np.float32)
    before = FK.fusion_map_cuda.launches
    got = fusion_map(p, prior, device=cuda_device)
    torch.cuda.synchronize()
    assert FK.fusion_map_cuda.launches == before + 1
    want = fusion_map(p, prior, device="cpu")
    torch.testing.assert_close(got.cpu(), want, atol=2e-6, rtol=1e-5)


@pytest.mark.cuda
def test_stochastic_head_on_the_card(cuda_device):
    x = np.random.default_rng(0).normal(0.0, 2.0, (3, 64, 50)).astype(np.float32)
    tok, conf = bayes_head.fuse_posteriors_stochastic(KD, x, n_bits=256, device=cuda_device)
    want_tok, want_conf = bayes_head.fuse_posteriors_stochastic(KD, x, n_bits=256, device="cpu")
    # same rule as the CPU test against the reference: a row may differ only
    # where the card's and the CPU's softmax straddle a DAC half step
    _, p_gpu = bayes_head._candidates(x, 8, cuda_device)
    _, p_cpu = bayes_head._candidates(x, 8, "cpu")
    same = (rng.threshold_from_p(p_gpu).cpu() == rng.threshold_from_p(p_cpu)).all(-1).all(0)
    assert int(same.sum()) >= len(same) - 1
    assert torch.equal(tok.cpu()[same], want_tok[same])
    torch.testing.assert_close(conf.cpu()[same], want_conf[same], atol=2e-6, rtol=1e-5)


@pytest.mark.cuda
def test_wrappers_reject_bad_input(cuda_device):
    p = torch.rand((2, 8, 3), device=cuda_device)
    with pytest.raises(ValueError):
        SK.sne_encode_cuda(1, 2, p.reshape(-1), n_bits=100)          # not whole words
    with pytest.raises(ValueError):
        SK.sne_encode_cuda(1, 2, p, n_bits=128)                      # not (R,)
    with pytest.raises(ValueError):
        SK.sne_encode_cuda(1, 2, p.reshape(-1).cpu(), n_bits=128)    # not on the card
    with pytest.raises(ValueError):
        BK.bayes_decide_cuda(1, 2, p, n_bits=48)
    with pytest.raises(ValueError):
        BK.bayes_decide_cuda(1, 2, p[0], n_bits=64)                  # not (M, R, K)
    with pytest.raises(ValueError):
        BK.bayes_decide_cuda(1, 2, p.double(), n_bits=64)
    words = torch.zeros((2, 8, 4), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        PK.pand_popcount_cuda(words.to(torch.int64))
    with pytest.raises(ValueError):
        PK.pand_popcount_cuda(words[0])
    with pytest.raises(ValueError):
        FK.fusion_map_cuda(p, torch.full((4,), 0.25, device=cuda_device))   # prior of K=4
    with pytest.raises(ValueError):
        FK.fusion_map_cuda(p, torch.full((3,), 1 / 3))                      # prior on the CPU
    with pytest.raises(ValueError):
        sne_encode(KD, p, 100, device=cuda_device)
    with pytest.raises(ValueError):
        bayes_decide(KD, p, 0, device=cuda_device)
