"""The port's ``node_mux`` CUDA kernels on the card (``cuda`` marker).

Needs an NVIDIA GPU with ``nvcc``; every test skips where
``torch.cuda.is_available()`` is False.  The file imports neither JAX nor the
reference package, so it runs on the machine with the card:

    python -m pytest -q -p no:cacheprovider tests/test_torch_cuda_node_mux.py

Each kernel is held bit for bit against its plain torch version, which
``test_torch_node_mux.py`` holds against the JAX reference on the CPU, on
entropy words drawn at the kernel's counter origin.  Then the unfused
program on the card against the same program compiled for the CPU.
"""

import numpy as np
import pytest
import torch

import repro_torch.bayesnet as T
from repro_torch.core import bitops, prng, rng
from repro_torch.kernels import node_mux, node_mux_categorical
from repro_torch.kernels.node_mux import kernel as K
from repro_torch.kernels.node_mux import ref

torch.set_num_threads(1)

KD = (0x9E3779B9, 0x2545F497)
WRAP = 2**32 - 1000        # counters of these draws wrap 2**32

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _words(seed, shape, dev):
    r = np.random.default_rng(seed).integers(0, 2**32, shape, dtype=np.uint64)
    return torch.from_numpy(r.astype(np.uint32).view(np.int32)).to(dev)


def _cpt(seed, rows, n_leaves, dev):
    p = torch.from_numpy(np.random.default_rng(seed).random((rows, n_leaves)).astype(np.float32))
    edge = torch.tensor([1 / 512, 3 / 512, 511 / 512, 0.0, 1.0, 1.5, -0.25])
    p.view(-1)[: min(p.numel(), edge.numel())] = edge[: min(p.numel(), edge.numel())]
    return p.to(dev)


def _entropy(shape, n_bits, offset, dev):
    return rng.counter_hash_words(np.asarray(KD, np.uint32), shape, n_bits // 4,
                                  offset=offset, device=dev)


@pytest.mark.parametrize("m", [0, 1, 2, 3, 6])
@pytest.mark.parametrize("rows,n_bits,offset", [(300, 256, 0), (1000, 4096, WRAP), (7, 32, 5)])
def test_gather_and_rows_kernels_equal_plain(cuda_device, m, rows, n_bits, offset):
    cpt = _cpt(m, rows, 1 << m, cuda_device)
    par = _words(m + 1, (m, rows, n_bits // 32), cuda_device)
    got = K.node_mux_gather_cuda(*KD, cpt, par, n_bits=n_bits, offset=offset)
    want = ref.node_mux_gather_ref(cpt, _entropy((rows,), n_bits, offset, cuda_device), par)
    assert torch.equal(got, want)
    got = K.node_mux_rows_cuda(*KD, cpt, par, n_bits=n_bits, offset=offset)
    want = ref.node_mux_ref(cpt, _entropy((rows, 1 << m), n_bits, offset, cuda_device), par)
    assert torch.equal(got, want)


@pytest.mark.parametrize("k,pcards", [(3, ()), (4, ()), (2, (3,)), (3, (2, 3)),
                                      (4, (4, 2)), (3, (4, 2, 3)), (5, (2, 2, 2, 2))])
@pytest.mark.parametrize("rows,n_bits,offset", [(257, 128, 0), (1000, 4096, WRAP)])
def test_cat_kernel_equals_plain(cuda_device, k, pcards, rows, n_bits, offset):
    n_leaves = int(np.prod(pcards)) if pcards else 1
    r = np.random.default_rng(k)
    cdf = -np.sort(-r.integers(0, 257, (rows, n_leaves, k - 1)), axis=-1)
    cdf = torch.from_numpy(cdf.astype(np.int32)).to(cuda_device)
    planes = sum(bitops.value_bits(c) for c in pcards)
    par = _words(k + 1, (planes, rows, n_bits // 32), cuda_device)
    got = K.node_mux_cat_cuda(*KD, cdf, par, cards=(k,) + pcards, n_bits=n_bits, offset=offset)
    want = ref.cat_gather_body(cdf, _entropy((rows,), n_bits, offset, cuda_device), par,
                               (k,) + pcards)
    assert torch.equal(got, want)


def test_ops_launch_the_kernels_and_count(cuda_device):
    key = np.asarray(KD, np.uint32)
    before = (K.node_mux_gather_cuda.launches, K.node_mux_rows_cuda.launches,
              K.node_mux_cat_cuda.launches)
    cpt = _cpt(1, 6, 4, "cpu")
    par = _words(2, (2, 6, 4), "cpu")
    for mode in ("gather", "rows"):
        got = node_mux(key, cpt, par, 128, mode=mode, device=cuda_device)
        assert torch.equal(got.cpu(), node_mux(key, cpt, par, 128, mode=mode, device="cpu"))
    cdf = torch.tensor([[[200, 90]]] * 6, dtype=torch.int32)
    none = torch.zeros((0, 6, 4), dtype=torch.int32)
    got = node_mux_categorical(key, cdf, none, cards=(3,), n_bits=128, device=cuda_device)
    assert torch.equal(got.cpu(), node_mux_categorical(key, cdf, none, cards=(3,), n_bits=128,
                                                       device="cpu"))
    after = (K.node_mux_gather_cuda.launches, K.node_mux_rows_cuda.launches,
             K.node_mux_cat_cuda.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1)


def test_kernels_refuse_what_they_do_not_take(cuda_device):
    cpt = _cpt(0, 4, 1 << 7, cuda_device)
    with pytest.raises(ValueError, match="at most"):
        K.node_mux_gather_cuda(*KD, cpt, _words(0, (7, 4, 1), cuda_device), n_bits=32)
    with pytest.raises(ValueError):
        K.node_mux_gather_cuda(*KD, cpt.cpu(), _words(0, (7, 4, 1), "cpu"), n_bits=32)
    with pytest.raises(ValueError):
        K.node_mux_rows_cuda(*KD, _cpt(0, 4, 4, cuda_device), _words(0, (2, 4, 2), cuda_device),
                             n_bits=32)


@pytest.mark.parametrize("name", sorted(T.SCENARIOS))
def test_unfused_program_on_the_card_equals_cpu(cuda_device, name):
    spec = T.by_name(name)
    r = np.random.default_rng(1)
    ev = np.stack([r.integers(0, spec.card(e), 64) for e in spec.evidence], 1).astype(np.int32)
    modes = [dict(fused=False), dict(share_entropy=True), dict(estimator="fill")]
    if spec.max_card() == 2:
        modes.append(dict(mux_mode="rows"))
    for kw in modes:
        got = T.compile_network(spec, n_bits=1024, device=cuda_device, **kw).decide(
            prng.PRNGKey(3), ev)
        want = T.compile_network(spec, n_bits=1024, device="cpu", **kw).decide(
            prng.PRNGKey(3), ev)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), (name, kw)


@pytest.mark.parametrize("name", ["intersection-cat", "obstacle-detection"])
def test_compiled_runs_never_wait_on_the_stream(cuda_device, name):
    spec = T.by_name(name)
    r = np.random.default_rng(2)
    ev = np.stack([r.integers(0, spec.card(e), 64) for e in spec.evidence], 1).astype(np.int32)
    modes = [dict(fused=False), dict(share_entropy=True), dict(estimator="fill"), {}]
    nets = [T.compile_network(spec, n_bits=1024, device=cuda_device, **kw) for kw in modes]
    for net in nets:            # the fused program uploads its gate program on first use
        net.decide(prng.PRNGKey(4), ev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for net in nets:
            net.decide(prng.PRNGKey(5), ev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
