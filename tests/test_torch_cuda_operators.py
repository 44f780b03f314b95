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
from repro_torch.kernels import backend, bayes_decide, bayes_decide_packed, fusion_map
from repro_torch.kernels import pand_popcount, sne_encode
from repro_torch.kernels.bayes_decide import kernel as BK
from repro_torch.kernels.bayes_decide import ops as bd_ops
from repro_torch.kernels.bayes_decide.ref import bayes_decide_ref
from repro_torch.kernels.fusion_map import kernel as FK
from repro_torch.kernels.fusion_map.ref import fusion_map_ref
from repro_torch.kernels.pand_popcount import kernel as PK
from repro_torch.kernels.sne_encode import kernel as SK
from repro_torch.kernels.sne_encode.ref import sne_encode_ref
from repro_torch.models import bayes_head
from repro_torch.obs import Tracer

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
    if p.ndim == 3 and p.shape[1] > 1:
        p[:, 1] = 0.0           # a row where every class ties at count 0
    return p


# (M, rows not a multiple of the block, K, n_bits, counter origin); then one
# row and the unfused root's 1024 rows of 4096 bits (sne_encode's shapes),
# bench_latency's decision (4096 x M = K = 2 x 128 bits), a bayes_head batch
# (64 tokens, top 8 classes, 256 bits), and K = 33 at M = 3
_CASES = [(1, 300, 2, 64, 0), (2, 4099, 16, 128, 0), (3, 257, 5, 96, WRAP),
          (2, 1000, 2, 256, WRAP), (3, 33, 1, 32, 2**32 + 5),
          (1, 1, 1, 4096, WRAP), (1, 1024, 1, 4096, 0), (2, 4096, 2, 128, 0),
          (2, 64, 8, 256, 0), (3, 100, 33, 128, WRAP)]
_IDS = [f"M{c[0]}-R{c[1]}-K{c[2]}-{c[3]}b-off{c[4]}" for c in _CASES]


def _check_integer_kernels(case, cuda_device, p=None):
    m, r, k, n_bits, offset = case
    tied = p is None and r > 1          # _probs sets row 1 to 0: every class ties
    p = torch.from_numpy(_probs(r + k, (m, r, k)) if p is None else p)
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
    if tied:
        assert int(dec[1]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", _CASES, ids=_IDS)
def test_integer_kernels_equal_plain_versions(case, cuda_device):
    _check_integer_kernels(case, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("fill", [None, 64], ids=["card", "chunked"])
@pytest.mark.parametrize("case", [(1, 300, 1, 96, WRAP), (3, 257, 5, 96, 0)],
                         ids=["M1-R300-K1-96b", "M3-R257-K5-96b"])
def test_integer_kernels_stride_past_their_grid(case, fill, cuda_device, monkeypatch):
    # one block: sne_encode's grid-stride loop carries (r, w) into the next
    # row (n_out = 3 divides neither the stride of 256 words nor 256 * chunk),
    # and bayes_decide's tile loop walks every tile of rows; on a card of
    # `fill` threads each thread classifies several items or streams, and a
    # tile holds more rows than a block has threads
    monkeypatch.setattr(SK, "MAX_BLOCKS", 1)
    monkeypatch.setattr(BK, "MAX_BLOCKS", 1)
    if fill is not None:
        monkeypatch.setattr(backend, "fill_threads", lambda index: fill)
    _check_integer_kernels(case, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("fill", [None, 256], ids=["card", "chunk8"])
@pytest.mark.parametrize("n_bits", [128, 4096])
def test_integer_kernels_on_peaked_posteriors(n_bits, fill, cuda_device, monkeypatch):
    # softmax of N(0, 3^2) logits over 16 classes: about 44 % of the streams
    # sit at level 0 or 256 and are stored without a hash, mixed in every warp;
    # with a card of `fill` threads each thread classifies 8 items, as at the
    # full paper-bayes-fusion batch
    if fill is not None:
        monkeypatch.setattr(backend, "fill_threads", lambda index: fill)
    m, r, k = 2, 3001, 16
    logits = 3.0 * np.random.default_rng(n_bits).standard_normal((m, r, k))
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    _check_integer_kernels((m, r, k, n_bits, WRAP), cuda_device, p)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [None, 1], ids=["grid", "one-block"])
@pytest.mark.parametrize("fill", [None, 256], ids=["streams", "queued"])
def test_bayes_decide_counts_the_streams_it_queues(fill, blocks, cuda_device, monkeypatch):
    # the card's own fill takes decide_streams (chunk 1), a card of 256
    # threads decide_queued (chunk 8); one block walks every tile, so its
    # one add carries the sum over tiles.  Counts and decisions are the
    # same with the counter on and off, and its total is the plain count
    if fill is not None:
        monkeypatch.setattr(backend, "fill_threads", lambda index: fill)
    if blocks is not None:
        monkeypatch.setattr(BK, "MAX_BLOCKS", blocks)
    m, r, k, n_bits = 2, 3001, 16, 128
    logits = 3.0 * np.random.default_rng(7).standard_normal((m, r, k))
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    p[0, :5, :] = 0.0                      # dead streams
    p[:, 5:9, :] = 1.0                     # full streams
    _, chunk, _ = BK.launch_split(r, k, n_bits // 32, backend.fill_threads(0))
    assert (chunk > 1) == (fill is not None)
    pc = torch.from_numpy(p).to(cuda_device)
    kd0, kd1 = (int(v) for v in KD)
    dec0, cnt0 = BK.bayes_decide_cuda(kd0, kd1, pc, n_bits=n_bits)
    queued = torch.zeros((), dtype=torch.int64, device=cuda_device)
    dec1, cnt1 = BK.bayes_decide_cuda(kd0, kd1, pc, n_bits=n_bits, queued=queued)
    BK.bayes_decide_cuda(kd0, kd1, pc, n_bits=n_bits, queued=queued)
    want = int(bd_ops.queued_streams(torch.from_numpy(p)))
    assert 0 < want < r * k
    assert int(queued) == 2 * want
    assert torch.equal(dec0, dec1) and torch.equal(cnt0, cnt1)
    tr = Tracer()
    dec2, cnt2 = bayes_decide(KD, p, n_bits, device=cuda_device, trace=tr)
    assert torch.equal(dec0, dec2) and torch.equal(cnt0, cnt2)
    assert tr.totals() == {"bayes_decide.queued": want, "bayes_decide.streams": r * k}


def _mix_probs(mix, seed, m, r, k):
    """(M, R, K) posteriors whose streams the kernel queues for hashing at
    about 0 % ("none": every level 0 or 256), 14 % ("day": softmax of
    N(0, 6^2) logits, the other modalities N(0, 3^2)), 53 % ("night":
    N(0, 1.5^2), then N(0, 3^2)) or 100 % ("all": every level in 3 .. 253).
    Day and night also hold the levels' edges: p at and beside 1/512 and
    511/512, 0, -0, 1, +-inf."""
    g = np.random.default_rng(seed)
    if mix == "none":
        return g.integers(0, 2, (m, r, k)).astype(np.float32)
    if mix == "all":
        return g.uniform(0.01, 0.99, (m, r, k)).astype(np.float32)
    scales = [(6.0 if mix == "day" else 1.5) if i == 0 else 3.0 for i in range(m)]
    logits = np.stack([s * g.standard_normal((r, k)) for s in scales])
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    lo, hi = np.float32(1 / 512), np.float32(511 / 512)
    edges = np.array([lo, np.nextafter(lo, np.float32(1)), np.nextafter(lo, np.float32(0)),
                      hi, np.nextafter(hi, np.float32(0)), np.nextafter(hi, np.float32(2)),
                      0.0, -0.0, 1.0, np.inf, -np.inf], np.float32)
    flat = p.reshape(m, -1)
    flat[:, :edges.size * 3] = np.resize(edges, edges.size * 3)[None, :]
    flat[1:, :edges.size * 3] = np.roll(flat[1:, :edges.size * 3], 1, axis=-1)
    return p


# (mix, M, R, K, n_bits) on the queued path (a card of 256 threads: chunk 8):
# the four queued shares at the paper's M = 2, K = 16; tiles of ragged rows
# (K = 3: 341 rows a tile, K = 19: 53); 32 and 256 bits; M = 1 and 3.  No R
# is a multiple of its tile, so the last tile is ragged.
_QUEUED = [("none", 2, 3001, 16, 128), ("day", 2, 3001, 16, 128),
           ("night", 2, 3001, 16, 128), ("all", 2, 3001, 16, 128),
           ("night", 3, 3001, 3, 32), ("day", 1, 3001, 19, 256),
           ("all", 1, 2999, 3, 256), ("night", 3, 1000, 19, 32)]
_SHARES = {"none": (0.0, 0.0), "day": (0.10, 0.20), "night": (0.45, 0.60), "all": (1.0, 1.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [None, 3, 1], ids=["grid", "three-blocks", "one-block"])
@pytest.mark.parametrize("case", _QUEUED, ids=[f"{c[0]}-M{c[1]}-R{c[2]}-K{c[3]}-{c[4]}b"
                                               for c in _QUEUED])
def test_bayes_decide_queued_path_equals_plain(case, blocks, cuda_device, monkeypatch):
    # pass 1 classifies a window's streams by comparing p with the levels'
    # edges, its loads in flight together; pass 2 hashes the queue.  On the
    # card's grid a block takes a tile, on three blocks and on one the tile
    # loop walks the rest.  Counts and decisions are the plain version's, and
    # the queued count is the thresholds rule's
    mix, m, r, k, n_bits = case
    monkeypatch.setattr(backend, "fill_threads", lambda index: 256)
    if blocks is not None:
        monkeypatch.setattr(BK, "MAX_BLOCKS", blocks)
    _, chunk, rows_per_tile = BK.launch_split(r, k, n_bits // 32, 256)
    assert chunk > 1 and r % rows_per_tile
    p = torch.from_numpy(_mix_probs(mix, r + k + m, m, r, k))
    want_q = int(bd_ops.queued_streams(p))
    lo, hi = _SHARES[mix]
    if (m, k) == (2, 16):
        assert lo <= want_q / (r * k) <= hi
    kd0, kd1 = (int(v) for v in KD)
    queued = torch.zeros((), dtype=torch.int64, device=cuda_device)
    dec, cnt = BK.bayes_decide_cuda(kd0, kd1, p.to(cuda_device), n_bits=n_bits, offset=WRAP,
                                    queued=queued)
    rand = rng.counter_hash_words(KD, (m, r, k), n_bits // 4, offset=WRAP)
    want_dec, want_cnt = bayes_decide_ref(p, rand)
    assert torch.equal(cnt.cpu(), want_cnt) and torch.equal(dec.cpu(), want_dec)
    assert int(queued) == want_q


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


# the redesigned kernel's routes: K a multiple of 4 up to 128 on lanes per
# row, K = 2 on whole rows per lane, any other K on the shared-memory tile
FM_ROUTE = {2: "pair", 3: "tile", 4: "group", 16: "group", 17: "tile", 64: "group", 130: "tile"}
FM_ROWS = (1, 7, 4096, 65537)


@pytest.mark.cuda
@pytest.mark.parametrize("k", sorted(FM_ROUTE))
@pytest.mark.parametrize("m", [1, 2, 3])
def test_fusion_map_kernel_on_every_route(m, k, cuda_device):
    """Every row count of FM_ROWS, a non-uniform prior and none (uniform),
    against the plain version on the same inputs on the card and on the CPU,
    within atol 2e-6, rtol 1e-5."""
    rs = np.random.default_rng(10 * m + k)
    for r in FM_ROWS:
        p = torch.from_numpy(_probs(r, (m, r, k))).to(cuda_device)
        for prior in (torch.from_numpy(rs.dirichlet(np.ones(k)).astype(np.float32)), None):
            dev_prior = None if prior is None else prior.to(cuda_device)
            before = FK.fusion_map_cuda.launches
            got = FK.fusion_map_cuda(p, dev_prior)
            assert FK.fusion_map_cuda.launches == before + 1
            assert FK.route(p, got) == FM_ROUTE[k]
            plain = torch.full((k,), 1.0 / k) if prior is None else prior
            want = fusion_map_ref(p, plain.to(cuda_device))
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, atol=2e-6, rtol=1e-5)
            torch.testing.assert_close(got.cpu(), fusion_map_ref(p.cpu(), plain),
                                       atol=2e-6, rtol=1e-5)


@pytest.mark.cuda
def test_fusion_map_on_an_unaligned_tensor_takes_the_tile_kernel(cuda_device):
    m, r, k = 2, 1000, 16
    p = torch.from_numpy(_probs(3, (m, r, k))).to(cuda_device)
    buf = torch.empty(p.numel() + 1, device=cuda_device)
    shifted = buf[1:].view(m, r, k)          # 4 bytes past a 16-byte boundary
    shifted.copy_(p)
    got = FK.fusion_map_cuda(shifted)
    assert FK.route(shifted, got) == "tile"
    torch.testing.assert_close(got, FK.fusion_map_cuda(p), atol=2e-6, rtol=1e-5)


@pytest.mark.cuda
def test_fusion_map_call_is_one_launch_and_no_copy(cuda_device):
    """``ops.fusion_map`` on a tensor on the card, with no prior (Fig 4's
    64x64 scene, M = 2, K = 2): one launch of the kernel, and nothing else on
    the card -- no host-to-device copy of a prior, no log-prior ops."""
    from torch.profiler import ProfilerActivity, profile

    p = torch.from_numpy(_probs(4, (2, 64 * 64, 2))).to(cuda_device)
    fusion_map(p, device=cuda_device)
    torch.cuda.synchronize()
    before = FK.fusion_map_cuda.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = fusion_map(p, device=cuda_device)
        torch.cuda.synchronize()
    assert FK.fusion_map_cuda.launches == before + 1
    on_card = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(on_card) == 1 and "fusion_map_kernel_pair" in on_card[0], on_card
    torch.testing.assert_close(got.cpu(), fusion_map(p.cpu(), device="cpu"), atol=2e-6,
                               rtol=1e-5)


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
        FK.fusion_map_cuda(p.transpose(1, 2).contiguous().transpose(1, 2))  # not contiguous
    with pytest.raises(ValueError):
        sne_encode(KD, p, 100, device=cuda_device)
    with pytest.raises(ValueError):
        bayes_decide(KD, p, 0, device=cuda_device)
