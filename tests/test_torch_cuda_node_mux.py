"""The port's ``node_mux`` CUDA kernels on the card (``cuda`` marker).

Needs an NVIDIA GPU with ``nvcc``; every test skips where
``torch.cuda.is_available()`` is False.  The file imports neither JAX nor the
reference package, so it runs on the machine with the card:

    python -m pytest -q -p no:cacheprovider tests/test_torch_cuda_node_mux.py

Each kernel is held bit for bit against its plain torch version, which
``test_torch_node_mux.py`` and ``test_torch_wide_nodes.py`` hold against the
JAX reference on the CPU, on entropy words drawn at the kernel's counter
origin: the templated binary kernels at 0-6 parents, per-row and shared
tables, their wide paths at 7 and 8, the categorical pattern-table kernel at
0-6 parent planes and its wide path above 8 planes and 16 parents.  Then the unfused program on the
card against the same program compiled for the CPU, networks with 7- and
8-parent nodes included.
"""

import numpy as np
import pytest
import torch

import repro_torch.bayesnet as T
from repro_torch.core import bitops, prng, rng
from repro_torch.kernels import node_mux, node_mux_categorical
from repro_torch.kernels.node_mux import kernel as K
from repro_torch.kernels.node_mux import ref
from torch_wide_net import wide_spec

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


def _shared_rows(m, dev):
    """(L,) shared CPT rows that together hold 0, 256 (also clipped from
    outside [0, 1]), 128 and the half steps (2k+1)/512: one row once L holds
    them all, else as many rows as they need."""
    edge = torch.tensor([0.0, 1.0, 0.5, 1 / 512, 3 / 512, 255 / 512, 257 / 512, 511 / 512,
                         1.5, -0.25])
    n_leaves = 1 << m
    fill = torch.from_numpy(np.random.default_rng(m).random(n_leaves).astype(np.float32))
    rows = []
    for i in range(0, edge.numel(), n_leaves):
        row = fill.clone()
        chunk = edge[i:i + n_leaves]
        row[: chunk.numel()] = chunk
        rows.append(row.to(dev))
    return rows


@pytest.mark.parametrize("shared", [False, True], ids=["per-row", "shared"])
@pytest.mark.parametrize("m", range(7))
@pytest.mark.parametrize("rows,n_bits,offset", [(300, 256, 0), (1000, 4096, WRAP), (7, 32, 5)])
def test_gather_and_rows_kernels_equal_plain(cuda_device, m, rows, n_bits, offset, shared):
    par = _words(m + 1, (m, rows, n_bits // 32), cuda_device)
    # one shared row for every row is passed with stride 0, as a compiled network passes it
    tables = [t.expand(rows, -1) for t in _shared_rows(m, cuda_device)] if shared \
        else [_cpt(m, rows, 1 << m, cuda_device)]
    for cpt in tables:
        got = K.node_mux_gather_cuda(*KD, cpt, par, n_bits=n_bits, offset=offset)
        want = ref.node_mux_gather_ref(cpt, _entropy((rows,), n_bits, offset, cuda_device), par)
        assert torch.equal(got, want)
        got = K.node_mux_rows_cuda(*KD, cpt, par, n_bits=n_bits, offset=offset)
        want = ref.node_mux_ref(cpt, _entropy((rows, 1 << m), n_bits, offset, cuda_device), par)
        assert torch.equal(got, want)


# P = 0..6 parent planes (6 binary parents at k = 2: a 6-parent gather's
# pattern-table route), then wide nodes: 9 planes (above the pattern table's
# 8) and 17 parents (above the former cap of 16 parents)
CAT_CASES = [(3, ()), (4, ()), (2, (3,)), (3, (2, 3)), (4, (4, 2)), (3, (4, 2, 3)),
             (5, (2, 2, 2, 2)), (2, (3, 2, 2, 2)), (2, (2,) * 6), (3, (2,) * 9),
             (3, (2,) * 17)]


@pytest.mark.parametrize("shared", [False, True], ids=["per-row", "shared"])
@pytest.mark.parametrize("k,pcards", CAT_CASES)
@pytest.mark.parametrize("rows,n_bits,offset", [(257, 128, 0), (1000, 4096, WRAP)])
def test_cat_kernel_equals_plain(cuda_device, k, pcards, rows, n_bits, offset, shared):
    planes = sum(bitops.value_bits(c) for c in pcards)
    if planes > 8:                    # the plain version's working set grows with L
        rows, n_bits = 7, 64
    n_leaves = int(np.prod(pcards)) if pcards else 1
    r = np.random.default_rng(k)
    cdf = -np.sort(-r.integers(0, 257, (1 if shared else rows, n_leaves, k - 1)), axis=-1)
    cdf = torch.from_numpy(cdf.astype(np.int32)).to(cuda_device).expand(rows, -1, -1)
    par = _words(k + 1, (planes, rows, n_bits // 32), cuda_device)
    cards = (k,) + pcards
    table = ref.cat_table(cdf[0] if shared else cdf, cards)
    counter = K.node_mux_cat_wide_cuda if planes > 8 else K.node_mux_cat_cuda
    before = counter.launches
    got = K.node_mux_cat_cuda(*KD, table, par, cards=cards, n_bits=n_bits, offset=offset)
    assert counter.launches == before + 1
    want = ref.cat_gather_body(cdf, _entropy((rows,), n_bits, offset, cuda_device), par, cards)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m", [7, 8])
@pytest.mark.parametrize("rows,n_bits,offset", [(300, 256, 0), (64, 1024, WRAP), (7, 32, 5)])
def test_wide_gather_and_rows_equal_plain(cuda_device, m, rows, n_bits, offset):
    cpt = _cpt(m, rows, 1 << m, cuda_device)
    par = _words(m + 1, (m, rows, n_bits // 32), cuda_device)
    # the wide gather runs on the pattern-table kernel at k = 2 (m <= 8 planes)
    before = (K.node_mux_cat_cuda.launches, K.node_mux_rows_wide_cuda.launches)
    got = K.node_mux_gather_cuda(*KD, cpt, par, n_bits=n_bits, offset=offset)
    want = ref.node_mux_gather_ref(cpt, _entropy((rows,), n_bits, offset, cuda_device), par)
    assert torch.equal(got, want)
    got = K.node_mux_rows_cuda(*KD, cpt, par, n_bits=n_bits, offset=offset)
    want = ref.node_mux_ref(cpt, _entropy((rows, 1 << m), n_bits, offset, cuda_device), par)
    assert torch.equal(got, want)
    # one shared CPT row for every row: passed with stride 0, never copied
    shared = cpt[:1].expand(rows, -1)
    got = K.node_mux_gather_cuda(*KD, shared, par, n_bits=n_bits, offset=offset)
    want = ref.node_mux_gather_ref(shared, _entropy((rows,), n_bits, offset, cuda_device), par)
    assert torch.equal(got, want)
    after = (K.node_mux_cat_cuda.launches, K.node_mux_rows_wide_cuda.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (2, 1)


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
    # 7 binary parents run (the wide gather); CPU tensors and parents that do
    # not match the CPT are refused
    cpt = _cpt(0, 4, 1 << 7, cuda_device)
    par = _words(0, (7, 4, 1), cuda_device)
    got = K.node_mux_gather_cuda(*KD, cpt, par, n_bits=32)
    assert torch.equal(got, ref.node_mux_gather_ref(cpt, _entropy((4,), 32, 0, cuda_device),
                                                    par))
    with pytest.raises(ValueError):
        K.node_mux_gather_cuda(*KD, cpt.cpu(), _words(0, (7, 4, 1), "cpu"), n_bits=32)
    with pytest.raises(ValueError):
        K.node_mux_rows_cuda(*KD, _cpt(0, 4, 4, cuda_device), _words(0, (2, 4, 2), cuda_device),
                             n_bits=32)


@pytest.mark.parametrize("name", sorted(T.SCENARIOS) + ["wide-7", "wide-8"])
def test_unfused_program_on_the_card_equals_cpu(cuda_device, name):
    spec = wide_spec(T, int(name[5:])) if name.startswith("wide-") else T.by_name(name)
    r = np.random.default_rng(1)
    ev = np.stack([r.integers(0, spec.card(e), 64) for e in spec.evidence], 1).astype(np.int32)
    modes = [dict(fused=False), dict(share_entropy=True), dict(estimator="fill"), {}]
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
